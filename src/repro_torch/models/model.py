"""Unified model interface: ``build_model(cfg)`` → a ``Model`` with init /
forward / prefill / decode_step / cache_init, as the reference's
``repro/models/model.py``.

``Model`` is an ``nn.Module`` that holds its parameters under the
reference's key names (``params.layers.0.attn.wq``, ``params.layers.0.ln1.scale``,
``params.embed``, ...) once ``init`` or ``load`` has given it some; the math is
plain functions on the nested dict of tensors that both return, and every
entry point takes that dict first, as the reference's take its pytree.
Parameters and caches live on the model's device: CUDA unless the caller
asks for another.
"""
from __future__ import annotations

import torch
from torch import nn

from . import transformer
from ..configs.base import ArchConfig
from ..core.dtypes import resolve_device


def _as_module(tree) -> tuple[nn.Module, dict | list]:
    """(a module tree holding ``tree``'s tensors as frozen parameters under
    the tree's keys, the same tree of those parameters)."""
    if isinstance(tree, dict):
        mod, out = nn.Module(), {}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                out[k] = nn.Parameter(v, requires_grad=False)
                mod.register_parameter(k, out[k])
            else:
                sub, out[k] = _as_module(v)
                mod.add_module(k, sub)
        return mod, out
    subs = [_as_module(v) for v in tree]
    return nn.ModuleList([m for m, _ in subs]), [t for _, t in subs]


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params: nn.Module | None = None

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen`` (made on ``gen``'s device), held by
        the model and returned as a dict."""
        return self.load(transformer.init_params(gen, self.cfg))

    def load(self, params: dict) -> dict:
        """Hold ``params`` (e.g. from ``convert.params_from_arrays``)."""
        self.params, tree = _as_module(params)
        return tree

    def forward(self, params: dict, tokens: torch.Tensor, memory=None) -> torch.Tensor:
        logits, _ = transformer.forward(params, tokens, self.cfg, memory)
        return logits

    def prefill(self, params: dict, tokens: torch.Tensor, memory=None) -> torch.Tensor:
        return transformer.prefill(params, tokens, self.cfg, memory)

    def decode_step(self, params: dict, token: torch.Tensor, cache: dict, memory=None):
        return transformer.decode_step(params, token, cache, self.cfg, memory)

    def cache_init(self, batch: int, s_max: int) -> dict:
        return transformer.cache_init(self.cfg, batch, s_max, self.device)

    def loss_fn(self, params: dict, batch: dict):
        raise NotImplementedError(
            "loss_fn is training, which the port has not brought over yet "
            "(ROADMAP M10: training with the kernels' backward passes)")

    def param_count(self) -> tuple[int, int]:
        return self.cfg.param_count()


def build_model(cfg: ArchConfig, device=None) -> Model:
    return Model(cfg, device)
