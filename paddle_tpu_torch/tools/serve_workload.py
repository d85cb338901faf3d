"""The serving workloads of the port's main path, in one place: both
`chip_smoke.py` (which times them) and `paddle_tpu_torch.tools.serve_profile`
(which profiles them) build them here, so the two always measure the same
thing.

Llama-2-7B width at its full 32 layers in bf16, random weights from a
seed; 8 lanes, a pool of 1024 blocks of 16 tokens, up to 128 blocks per
sequence, chunked prefill of 32 tokens. The requests are 8 prompts of
64-512 tokens from `numpy.random.default_rng(0)`, each asking for 32 new
tokens: 6 greedy, 2 sampled at temperature 0.8, top-k 50. The quantized
modes serve the same traffic: `kv_bits=8` builds an int8 KV pool, and
`wbits=8|4` runs `serving.quant.quantize_engine` on the built engine
(the JAX package's `serving_quant` mode is `kv_bits=8, wbits=8`).

`spec="ngram"|"draft"` serves speculatively with K = 4 drafts
(`bench.py serving_spec`'s default K): `NGramProposer()`, or
`DraftEngineProposer` over a second engine holding the target's own
weights (a self-draft: random weights have no smaller model that agrees
with them). Each prompt then repeats a phrase of 3-5 random tokens to its
length, the repetition-heavy trace of `bench.py serving_spec`, at the same
lengths and sampling as the plain workload.

`generate_workload` is `LlamaInferenceEngine.generate` on the same
seed-0 weights: 2 prompts of 128 tokens, 16 new greedy tokens.
"""
from __future__ import annotations

import numpy as np
import torch

# serving geometry
LAYERS, B, BS, NB, MAXB, CHUNK = 32, 8, 16, 1024, 128, 32
NEW_TOKENS = 32
SPEC_K = 4
# generate: prompts x tokens, new tokens
GEN_PROMPTS, GEN_LEN, GEN_NEW = 2, 128, 16


def _model(device):
    from .. import llama_7b_shaped

    return llama_7b_shaped(num_layers=LAYERS, device=device,
                           dtype=torch.bfloat16,
                           generator=torch.Generator(
                               device=device).manual_seed(0))


def _engine(model, device, kv_bits=16, max_batch_size=B):
    from .. import LlamaInferenceEngine

    return LlamaInferenceEngine(model, max_batch_size=max_batch_size,
                                num_blocks=NB, block_size=BS,
                                max_blocks_per_seq=MAXB, kv_bits=kv_bits,
                                device=device)


def serve_workload(device="cuda", kv_bits=16, wbits=None, spec=None):
    """Build the engine (`kv_bits` 16 or 8; `wbits` None, 8 or 4 for
    `quantize_engine`; `spec` None, "ngram" or "draft") and its frontend
    on `device`, serve one short warm-up request (cuBLAS handles, first
    launches), and return `(frontend, requests)`, where `requests` is a
    list of `(prompt, submit_kwargs)` not yet submitted."""
    from .. import ServingFrontend
    from ..serving import DraftEngineProposer, NGramProposer, SpecDecodeConfig
    from ..serving.quant import quantize_engine

    if spec not in (None, "ngram", "draft"):
        raise ValueError(f"spec must be None, 'ngram' or 'draft', got "
                         f"{spec!r}")
    model = _model(device)
    engine = _engine(model, device, kv_bits)
    config = None
    if spec == "ngram":
        config = SpecDecodeConfig(NGramProposer(), SPEC_K)
    elif spec == "draft":
        # the proposer drives one sequence at a time; its pool holds every
        # in-flight context. The draft engine shares every weight the
        # target shares with the model (o, down, norms, embedding, head)
        # and concatenates its own q/k/v and gate/up.
        config = SpecDecodeConfig(
            DraftEngineProposer(_engine(model, device, max_batch_size=1)),
            SPEC_K)
    del model                     # the engines hold what they serve
    if wbits is not None:
        quantize_engine(engine, wbits)
    fe = ServingFrontend(engine, prefill_chunk_tokens=CHUNK, spec=config)
    fe.submit(list(range(1, 17)), max_new_tokens=2)
    fe.run_until_idle()

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, B)
    prompts = []
    for n in lens:
        if spec is None:
            prompts.append(rng.integers(1, 32000, n).tolist())
        else:
            phrase = rng.integers(1, 32000, int(rng.integers(3, 6)))
            prompts.append(np.resize(phrase, n).tolist())
    requests = [(p, dict(max_new_tokens=NEW_TOKENS,
                         **({} if i < 6 else dict(temperature=0.8, top_k=50,
                                                  seed=i))))
                for i, p in enumerate(prompts)]
    return fe, requests


def generate_workload(device="cuda"):
    """Build the engine on `device` (the serve workload's weights and
    pool) and return `(engine, prompts [GEN_PROMPTS, GEN_LEN] int32,
    GenerationConfig)` for `engine.generate`: greedy, `GEN_NEW` new
    tokens, prompts from `numpy.random.default_rng(0)`."""
    from ..inference import GenerationConfig

    model = _model(device)
    engine = _engine(model, device)
    del model
    prompts = np.random.default_rng(0).integers(
        1, 32000, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    return engine, prompts, GenerationConfig(max_new_tokens=GEN_NEW)
