"""Layers and their functional helpers (the port's slice of
`paddle_tpu/nn`: weight-only quantization, `nn/quant.py`)."""
