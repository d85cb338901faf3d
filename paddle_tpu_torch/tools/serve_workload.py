"""The serving workload of the port's main path, in one place: both
`chip_smoke.py` (which times it) and `paddle_tpu_torch.tools.serve_profile`
(which profiles it) build it here, so the two always measure the same
thing.

Llama-2-7B width at its full 32 layers in bf16, random weights from a
seed; 8 lanes, a pool of 1024 blocks of 16 tokens, up to 128 blocks per
sequence, chunked prefill of 32 tokens. The requests are 8 prompts of
64-512 tokens from `numpy.random.default_rng(0)`, each asking for 32 new
tokens: 6 greedy, 2 sampled at temperature 0.8, top-k 50. The quantized
modes serve the same traffic: `kv_bits=8` builds an int8 KV pool, and
`wbits=8|4` runs `serving.quant.quantize_engine` on the built engine
(the JAX package's `serving_quant` mode is `kv_bits=8, wbits=8`).
"""
from __future__ import annotations

import numpy as np
import torch

# serving geometry
LAYERS, B, BS, NB, MAXB, CHUNK = 32, 8, 16, 1024, 128, 32
NEW_TOKENS = 32


def serve_workload(device="cuda", kv_bits=16, wbits=None):
    """Build the engine (`kv_bits` 16 or 8; `wbits` None, 8 or 4 for
    `quantize_engine`) and its frontend on `device`, serve one short
    warm-up request (cuBLAS handles, first launches), and return
    `(frontend, requests)`, where `requests` is a list of
    `(prompt, submit_kwargs)` not yet submitted."""
    from .. import LlamaInferenceEngine, ServingFrontend, llama_7b_shaped
    from ..serving.quant import quantize_engine

    model = llama_7b_shaped(num_layers=LAYERS, device=device,
                            dtype=torch.bfloat16,
                            generator=torch.Generator(
                                device=device).manual_seed(0))
    engine = LlamaInferenceEngine(model, max_batch_size=B, num_blocks=NB,
                                  block_size=BS, max_blocks_per_seq=MAXB,
                                  kv_bits=kv_bits, device=device)
    del model                     # the engine holds what it serves
    if wbits is not None:
        quantize_engine(engine, wbits)
    fe = ServingFrontend(engine, prefill_chunk_tokens=CHUNK)
    fe.submit(list(range(1, 17)), max_new_tokens=2)
    fe.run_until_idle()

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, B)
    requests = [(rng.integers(1, 32000, n).tolist(),
                 dict(max_new_tokens=NEW_TOKENS,
                      **({} if i < 6 else dict(temperature=0.8, top_k=50,
                                               seed=i))))
                for i, n in enumerate(lens)]
    return fe, requests
