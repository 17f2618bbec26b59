"""Model zoo of the port: every architecture of the reference's
``repro.models`` on PyTorch — dense and local attention, RG-LRU, RWKV6, MoE,
and cross-attention / encoder-decoder blocks."""
from .model import (Model, build_model, cache_specs, input_specs,  # noqa: F401
                    params_specs)
