"""``Model.prefill`` under a closed loop of batches: batch x S random
tokens, S from the mix's lengths, each batch's last-position logits on the
card (synchronized) before the next begins."""
from __future__ import annotations

import torch

from .. import generate, weights
from ..cost import head_dim
from ..harness import seed_ints


def model(cfg: dict, w: dict, device):
    """(repro_torch Model, its parameter dict) over the benchmark's weights
    ``w``, built by the program from the configuration the file names.  Raises
    where the program's configuration differs from the file's."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import build_model
    # the CPU tests run the program's reduced ("smoke") variant of the config
    get = get_smoke_config if cfg.get("program_variant") == "smoke" else get_config
    arch = get(cfg["program_config"])
    want = {"d_model": cfg["hidden_size"], "d_ff": cfg["intermediate_size"],
            "n_heads": cfg["num_attention_heads"], "n_kv": cfg["num_key_value_heads"],
            "n_layers": cfg["num_hidden_layers"], "vocab": cfg["vocab_size"],
            "head_dim_": head_dim(cfg), "mlp": "swiglu", "norm": "rmsnorm", "use_rope": True,
            "tie_embeddings": cfg["tie_word_embeddings"], "pattern": ("attn",),
            "window": None, "qkv_bias": False, "attn_impl": "auto"}
    have = {k: getattr(arch, k) for k in want}
    if have != want:
        raise ValueError(f"the program's {cfg['program_config']} is not the file's: "
                         f"{ {k: (have[k], want[k]) for k in want if have[k] != want[k]} }")
    m = build_model(arch, device)
    return m, m.load(weights.program_tree(w, cfg))


class State:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.traffic = ctx, ctx.cell.config, ctx.cell.traffic
        self.weights = weights.make(self.cfg, ctx.seed, ctx.device)
        self.model, self.params = model(self.cfg, self.weights, ctx.device)
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


def setup(ctx):
    return State(ctx)


def unit(state: State, i: int) -> dict:
    return state.run()


def info(state: State) -> dict:
    return {"batches": len(state.batches)}


def payload(state: State) -> dict:
    """The batches the check compares: one of the longest, and others,
    drawn from the seed."""
    n = len(state.batches)
    want = int(state.traffic["check_batches"])
    longest = max(t.shape[1] for t, _ in state.batches)
    picks = generate.sample(state.ctx.seed, n, n)
    first = next(i for i in picks if state.batches[i][0].shape[1] == longest)
    chosen = [first] + [i for i in picks if i != first][:want - 1]
    return {"kind": "prefill", "weights": state.weights,
            "batches": [state.batches[i] for i in chosen]}


def release(state: State) -> None:
    state.model = state.params = None
