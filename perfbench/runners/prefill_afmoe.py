"""``Model.prefill`` of an AFMoE model (``configs/trinity-mini.json``) under
a closed loop of batches, as ``prefill`` drives a dense one: batch x S
random tokens, S from the mix's lengths, each batch's last-position logits
on the card (synchronized) before the next begins.

After the window the checked batches are run once more with the program's
expert choices recorded (``repro_torch.models.moe.record_routes``); the
rerun's logits must equal the window's bit for bit, and the choices go to
the reference with them (its note on near-ties says why)."""
from __future__ import annotations

import math

import torch

from .. import generate, weights_afmoe
from ..harness import seed_ints

# what the program must run, beside the file's shapes
_FIXED = {"mlp": "moe", "moe_dispatch": "dropless", "qk_norm": True,
          "attn_gate": True, "sandwich_norm": True, "rope_global": False, "use_rope": True,
          "norm": "rmsnorm", "attn_impl": "auto", "qkv_bias": False}


def shapes_of(arch) -> dict:
    """The configuration file's keys of the program's config ``arch``."""
    kinds = {"local": "sliding_attention", "attn": "full_attention"}
    return {"hidden_size": arch.d_model, "num_attention_heads": arch.n_heads,
            "num_key_value_heads": arch.n_kv, "head_dim": arch.head_dim_,
            "num_hidden_layers": arch.n_layers, "vocab_size": arch.vocab,
            "intermediate_size": arch.d_ff_dense, "moe_intermediate_size": arch.d_ff,
            "num_experts": arch.n_experts, "num_experts_per_tok": arch.top_k,
            "num_shared_experts": arch.n_shared_experts,
            "num_dense_layers": arch.n_dense_layers, "sliding_window": arch.window,
            "layer_types": [kinds[arch.pattern[i % len(arch.pattern)]]
                            for i in range(arch.n_layers)],
            "route_scale": arch.route_scale, "rms_norm_eps": arch.norm_eps,
            "tie_word_embeddings": arch.tie_embeddings}


def program_config(cfg: dict):
    """(the program's config, the file's configuration as it runs).  Under
    ``program_variant: smoke`` (the CPU tests) every shape comes from the
    program's reduced config.  Raises where the program's config is not the
    file's: another shape, or equations the file does not state (RoPE's
    theta is fixed at 10,000 in the program, the embedding scale at
    sqrt(hidden_size))."""
    from repro_torch.configs import get_config, get_smoke_config
    smoke = cfg.get("program_variant") == "smoke"
    arch = (get_smoke_config if smoke else get_config)(cfg["program_config"])
    have = shapes_of(arch)
    if smoke:
        cfg = dict(cfg, **have)
    want = {k: cfg[k] for k in have}
    have.update({k: getattr(arch, k) for k in _FIXED})
    want.update(_FIXED)
    have["rope_theta"], want["rope_theta"] = 10000.0, float(cfg["rope_theta"])
    have["embedding_multiplier"] = math.sqrt(arch.d_model)
    want["embedding_multiplier"] = cfg["program_departures"].get(
        "embedding_multiplier", math.sqrt(cfg["hidden_size"]))
    if have != want:
        raise ValueError(f"the program's {cfg['program_config']} is not the file's: "
                         f"{ {k: (have[k], want[k]) for k in want if have[k] != want[k]} }")
    return arch, cfg


class State:
    def __init__(self, ctx):
        from repro_torch.models.model import build_model
        self.ctx, self.traffic = ctx, ctx.cell.traffic
        arch, self.cfg = program_config(ctx.cell.config)
        self.weights = weights_afmoe.make(self.cfg, ctx.seed, ctx.device)
        self.model = build_model(arch, ctx.device)
        self.params = self.model.load(weights_afmoe.program_tree(self.weights, self.cfg))
        self.gen = torch.Generator(device=ctx.device)
        self.gen.manual_seed(seed_ints(ctx.seed, 3)[2])
        self.lens = generate.sequence_lengths(self.traffic, ctx.seed)
        self.batches = []
        for s in self.traffic["seq_lens"]:        # the cell's shapes, once each
            self.model.prefill(self.params, self.tokens(s))
        self.sync()

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def tokens(self, s: int):
        return torch.randint(3, self.cfg["vocab_size"], (self.traffic["batch"], s),
                             generator=self.gen, device=self.ctx.device, dtype=torch.int32)

    def run(self) -> dict:
        s = next(self.lens)
        toks = self.tokens(s)
        logits = self.model.prefill(self.params, toks)
        self.sync()
        self.batches.append((toks, logits))
        b = self.traffic["batch"]
        return {"label": f"prefill {b}x{s}", "batch": b, "seq": s, "tokens": b * s}

    def rerun(self, toks, logits) -> list:
        """The program's expert choices on ``toks``, from a rerun whose
        logits must equal ``logits`` bit for bit."""
        from repro_torch.models import moe
        with moe.record_routes() as routes:
            again = self.model.prefill(self.params, toks)
        self.sync()
        if not torch.equal(again, logits):
            raise RuntimeError("a rerun of a checked batch gave other logits than the window's")
        return list(routes)


def setup(ctx):
    return State(ctx)


def unit(state: State, i: int) -> dict:
    return state.run()


def info(state: State) -> dict:
    return {"batches": len(state.batches)}


def payload(state: State) -> dict:
    """The batches the check compares, each with the program's expert
    choices: one of the longest, and others, drawn from the seed."""
    n = len(state.batches)
    want = int(state.traffic["check_batches"])
    longest = max(t.shape[1] for t, _ in state.batches)
    picks = generate.sample(state.ctx.seed, n, n)
    first = next(i for i in picks if state.batches[i][0].shape[1] == longest)
    chosen = [state.batches[i] for i in [first] + [i for i in picks if i != first][:want - 1]]
    return {"kind": "prefill", "weights": state.weights, "config": state.cfg,
            "batches": [(t, lg, state.rerun(t, lg)) for t, lg in chosen]}


def release(state: State) -> None:
    state.model = state.params = None
