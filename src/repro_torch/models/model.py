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

``loss_fn`` is what training differentiates (``transformer.train_forward``:
the einsum attention paths, remat).  The inference entry points
(``forward``, ``prefill``, ``decode_step``) run under ``torch.no_grad()``,
so they record nothing even when the parameters require grad, as the
trainer's do.  Each takes the ``memory`` a config with
``cross_memory_len`` attends to (frame embeddings that ``forward`` /
``prefill`` / ``loss_fn`` encode first when the config has an encoder; an
already encoded memory for ``decode_step``).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers, transformer
from ..configs.base import ArchConfig, ShapeConfig
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


def _needs_memory(cfg: ArchConfig) -> bool:
    """Whether the model's cross / dec layers attend to a memory (B,
    cross_memory_len, d): VLM patch or audio frame embeddings."""
    return cfg.cross_memory_len > 0


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

    @torch.no_grad()
    def forward(self, params: dict, tokens: torch.Tensor, memory=None) -> torch.Tensor:
        logits, _ = transformer.forward(params, tokens, self.cfg, memory)
        return logits

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor, memory=None) -> torch.Tensor:
        return transformer.prefill(params, tokens, self.cfg, memory)

    @torch.no_grad()
    def decode_step(self, params: dict, token: torch.Tensor, cache: dict, memory=None):
        return transformer.decode_step(params, token, cache, self.cfg, memory)

    def cache_init(self, batch: int, s_max: int) -> dict:
        return transformer.cache_init(self.cfg, batch, s_max, self.device)

    def loss_fn(self, params: dict, batch: dict):
        """(loss, {"xent", "moe_aux"}) of a batch {"tokens", "labels",
        "mask"?, "memory"?}, as the reference's: the next-token cross entropy
        with z-loss plus the MoE auxiliary loss (0 without MoE layers)."""
        logits, aux = transformer.train_forward(params, batch["tokens"], self.cfg,
                                                batch.get("memory"))
        xent = layers.softmax_xent(logits, batch["labels"], batch.get("mask"))
        return xent + aux, {"xent": xent, "moe_aux": aux}

    def param_count(self) -> tuple[int, int]:
        return self.cfg.param_count()


def build_model(cfg: ArchConfig, device=None) -> Model:
    return Model(cfg, device)


# =============================================================================
# meta stand-ins for the dry-run (no allocation)
# =============================================================================
_META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta tensors of a (shape-kind) batch: tokens / labels / mask for
    train, tokens for prefill, one token a slot for decode, and the memory
    a config with ``cross_memory_len`` attends to."""
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = torch.empty((b, s), dtype=torch.int32, device=_META)
        specs["labels"] = torch.empty((b, s), dtype=torch.int32, device=_META)
        specs["mask"] = torch.empty((b, s), dtype=torch.float32, device=_META)
    elif shape.kind == "prefill":
        specs["tokens"] = torch.empty((b, s), dtype=torch.int32, device=_META)
    else:  # decode: one new token against an S-long cache
        specs["token"] = torch.empty((b,), dtype=torch.int32, device=_META)
    if _needs_memory(cfg):
        specs["memory"] = torch.empty((b, cfg.cross_memory_len, cfg.d_model),
                                      dtype=torch.bfloat16, device=_META)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, s_max: int) -> dict:
    """The decode cache of ``batch`` slots and ``s_max`` positions, on meta."""
    return transformer.cache_init(cfg, batch, s_max, _META)


def params_specs(cfg: ArchConfig) -> dict:
    """The parameter tree of ``cfg`` on meta: ``init_params`` runs under a
    fake-tensor mode (shapes and dtypes only; its generator is never drawn
    from), and each leaf becomes a meta tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..train.tree import leaves, unflatten
    with FakeTensorMode():
        fake = transformer.init_params(torch.Generator(), cfg)
    return unflatten(fake, [torch.empty(t.shape, dtype=t.dtype, device=_META)
                            for t in leaves(fake)])
