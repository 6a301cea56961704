"""Small sizes of the benchmark's cells, for runs on the CPU: the
configurations' widths cut to a few dozen, and the traffic to a few dozen
short requests in a 4-second window, little enough to finish on a loaded
host.  The mixes keep their shape (tenants, shares, arrivals, batch in
microbatches)."""
import torch

from bench.harness import traffic, weights

CPU = torch.device("cpu")
SIZES = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             vocab_size=512)
SEED = 2**31 + 12345          # past 32 signed bits, as the driver's are

SERVE = "mistral-large-123b.serve.prefix-chat"
TRAIN = "smollm-360m.train.2k"
CELLS = (SERVE, TRAIN)


def config(cell: str) -> dict:
    name = {SERVE: "mistral-large-123b.pp4"}.get(cell, "smollm-360m")
    cfg = {**weights.load_config(name), **SIZES}
    cfg["serving"] = {**cfg["serving"], "num_pages": 1024}
    return cfg


def mix(cell: str) -> dict:
    name = {SERVE: "serve.prefix-chat", TRAIN: "train.2k"}[cell]
    m = traffic.load(name)
    if m["kind"] == "train":
        return {**m, "global_batch": 8, "seq_len": 64, "corpus_steps": 8}
    small = {"output": {"median": 6, "sigma": 0.3, "min": 4, "max": 8},
             "suffix": {"median": 16, "sigma": 0.8, "min": 8, "max": 48},
             "prefixes": [{**p, "tokens": p["tokens"] // 16}
                          for p in m["prefixes"]],
             "sample_tokens": 48, "warmup_s": 0.5, "rate_per_s": 3.0}
    return {**m, **small}


SECONDS = 4.0

# the limits at these sizes, set as the cells' are, from readings on six
# seeds or more: above the program's widest (serving 0.059 over 16 runs;
# training: gradient norm 1.6e-3, worst leaf gradient 2.3e-3, worst leaf
# gradient difference 0.029, worst leaf change 1.3e-3, worst leaf change's
# difference 0.073) and below the fp8 control's narrowest (serving 0.22;
# leaf gradient difference 0.21; leaf change's difference 0.35) and the
# faults' (half a batch: gradient norm 0.38; a state left unchanged: 1 on
# the leaf numbers; a change of the wrong sign: 2 on the change's
# difference)
SERVE_LIMITS = {"widest_gap_std": 0.12}
TRAIN_LIMITS = {"grad_norm_gap": 0.03, "grad_leaf_gap": 0.01,
                "grad_diff_leaf_gap": 0.08, "update_leaf_gap": 0.01,
                "update_diff_leaf_gap": 0.15, "rows_not_in_corpus": 0}


def limits(cell: str) -> dict:
    return TRAIN_LIMITS if cell == TRAIN else SERVE_LIMITS
