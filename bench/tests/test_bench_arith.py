"""The yardstick's operation and byte counts against counts by hand: the
shapes' own (``arith``) and the dense family's."""
import pytest

from bench.families import dense
from bench.harness import arith, weights

SMOLLM = dense.sizes(weights.load_config("smollm-360m"))
MISTRAL = dense.sizes(weights.load_config("mistral-large-123b.pp4"))


def test_weights():
    # q 960², k and v 960·320 each, o 960², gate, up and down 960·2560
    assert dense.layer_matmul_params(SMOLLM) == 9_830_400
    assert dense.matmul_params(SMOLLM) == 32 * 9_830_400 + 49152 * 960
    # with the norms: SmolLM-360M's 361,821,120 parameters (tied head)
    assert dense.weight_bytes(SMOLLM) == 2 * 361_821_120
    # one pipeline stage of Mistral-Large: 22 layers of 1,384,120,320
    # matmul weights, the embedding's 402,653,184 not read by decode
    assert dense.layer_matmul_params(MISTRAL) == 1_384_120_320
    assert dense.matmul_params(MISTRAL) == 22 * 1_384_120_320 + 402_653_184


def test_flash_bound_at_the_train_microbatch():
    # chip_smoke.py's smollm train shape: B 4, S 2048, 15/5 heads of 64:
    # 41,943,040 bytes and 32,227,983,360 operations, bound by operations
    flops = 4 * 64 * 4 * 15 * (2048 * 2049 // 2)
    assert flops == 32_227_983_360
    assert arith.flash_bound_s(4, 2048, 15, 5, 64) == pytest.approx(
        flops / 989e12, rel=1e-12)
    # a short prompt is bound by its bytes: q, k, v and the output once
    nbytes = 2 * (2 * 1 * 64 * 15 * 64 + 2 * 1 * 64 * 5 * 64)
    assert arith.flash_bound_s(1, 64, 15, 5, 64) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)


def test_paged_bound_counts_a_shared_prefix_once():
    # chip_smoke.py's mid-run table: rows of 516 and 7 × 580 tokens whose
    # first 31 pages of 16 are one shared prefix; H 28, Hkv 4, D 128
    lens = [516] + [580] * 7
    unique = arith.unique_kv_tokens([(0, n) for n in lens], {0: 31 * 16})
    assert unique == sum(lens) - 7 * 31 * 16
    nbytes = unique * 2 * 4 * 128 * 2 + 2 * 8 * 28 * 128 * 2 \
        + 4 * 8 * 37 + 4 * 8
    flops = 4 * 128 * 28 * sum(lens)
    assert arith.paged_bound_s(28, 4, 128, 8, sum(lens), 580, unique,
                               16) == pytest.approx(
        max(nbytes / 3.35e12, flops / 989e12), rel=1e-12)


def test_a_row_without_a_prefix_reads_its_own_tokens():
    # rows of a mix with no shared prompts (key None) beside two forks of
    # one root whose first 2 pages of 16 they share
    rows = [(None, 40), (None, 57), (0, 70), (0, 90)]
    assert arith.unique_kv_tokens(rows, {0: 32}) == 40 + 57 + 70 + 90 - 32
    assert arith.unique_kv_tokens(rows[:2], {}) == 97


def test_step_counts():
    s = 2048
    attn = 32 * 4 * 15 * 64 * (s * (s + 1) // 2)
    assert dense.attention_flops(SMOLLM, s) == attn
    assert dense.train_flops(SMOLLM, 8, s) == \
        6 * dense.matmul_params(SMOLLM) * 8 * s + 3 * 8 * attn
    assert dense.prefill_flops(MISTRAL, 1000) == \
        2 * 22 * 1_384_120_320 * 1000 + 2 * 32768 * 12288 \
        + 22 * 4 * 96 * 128 * 500_500
    # a decode step of 3 rows over 100 + 200 + 300 keys: the weights once,
    # K/V of 8 heads of 128 in 22 layers per token
    assert dense.decode_flops(MISTRAL, 3, 600) == \
        2 * dense.matmul_params(MISTRAL) * 3 + 22 * 4 * 96 * 128 * 600
    assert dense.decode_bytes(MISTRAL, 600) == \
        dense.weight_bytes(MISTRAL) + 600 * 22 * 2 * 8 * 128 * 2


def test_a_fork_is_charged_its_suffix_alone():
    # a 1000-token prompt forked from a 600-token root: 400 tokens through
    # 22 layers' weights, their 400 rows of causal pairs (positions 601 to
    # 1000: 500,500 − 180,300 pairs) and the output head once
    assert dense.attention_flops(MISTRAL, 1000, 600) == \
        22 * 4 * 96 * 128 * (500_500 - 180_300)
    assert dense.prefill_flops(MISTRAL, 1000, 600) == \
        2 * 22 * 1_384_120_320 * 400 + 2 * 32768 * 12288 \
        + 22 * 4 * 96 * 128 * 320_200
    # the root's prefill and the fork's together are the whole prompt's,
    # but for the second output head
    assert dense.prefill_flops(MISTRAL, 1000, 600) \
        + dense.prefill_flops(MISTRAL, 600) \
        == dense.prefill_flops(MISTRAL, 1000) + 2 * 32768 * 12288


def test_flash_bound_of_a_fork_reads_every_key_once():
    # queries of positions 601..1000 over all 1000 keys, 96 / 8 heads of
    # 128: 15,738,470,400 operations; q and o of 400 tokens, k and v of
    # 1000: 23,756,800 bytes; bound by operations
    flops = 4 * 128 * 96 * 320_200
    assert flops == 15_738_470_400
    nbytes = 2 * (2 * 400 * 96 * 128 + 2 * 1000 * 8 * 128)
    assert nbytes == 23_756_800
    assert arith.flash_bound_s(1, 1000, 96, 8, 128, 600) == pytest.approx(
        flops / 989e12, rel=1e-12)
    # a 16-token suffix behind a 2200-token prefix is bound by the keys'
    # bytes
    nbytes = 2 * (2 * 16 * 96 * 128 + 2 * 2216 * 8 * 128)
    flops = 4 * 128 * 96 * (2216 * 2217 // 2 - 2200 * 2201 // 2)
    assert nbytes / 3.35e12 > flops / 989e12
    assert arith.flash_bound_s(1, 2216, 96, 8, 128, 2200) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)


class Trace:
    """A device trace that holds ``secs`` seconds of each named kernel."""

    def __init__(self, **secs):
        self.secs = secs

    def seconds(self, names):
        hits = [self.secs[n] for n in names if n in self.secs]
        return sum(hits) if hits else None


# two admissions of 1.0 s and 0.5 s: 1000 tokens forked from a 600-token
# root, and 700 from a 600-token root
ADDS = [("engine.add", 10.0, 11.0, 1000, 600),
        ("engine.step", 11.0, 11.1, 2),
        ("engine.add", 11.1, 11.6, 700, 600)]


def test_prefill_readers_charge_each_fork_its_suffix():
    from bench.harness.cell import reader
    ctx = {"sizes": MISTRAL, "family": dense, "spans": ADDS}
    flops = dense.prefill_flops(MISTRAL, 1000, 600) \
        + dense.prefill_flops(MISTRAL, 700, 600)
    assert reader("mfu.prefill")(ctx) == pytest.approx(
        100 * flops / (1.5 * 989e12), rel=1e-12)
    # milliseconds per thousand prompt tokens, the prefix's with them
    assert reader("prefill_ms_per_ktok.serve")(ctx) == pytest.approx(
        1500 / 1.7, rel=1e-12)
    least = 22 * (arith.flash_bound_s(1, 1000, 96, 8, 128, 600)
                  + arith.flash_bound_s(1, 700, 96, 8, 128, 600))
    ctx["trace"] = Trace(flash_bf16=0.01)
    assert reader("flash_roofline.prefill")(ctx) == pytest.approx(
        100 * least / 0.01, rel=1e-12)


def test_readers_find_nothing_without_their_spans_or_kernels():
    from bench.harness.cell import reader
    empty = {"sizes": MISTRAL, "family": dense, "spans": [], "steps": [],
             "trace": Trace()}
    for name in ("mfu.prefill", "prefill_ms_per_ktok.serve",
                 "flash_roofline.prefill", "decode_step_ms.serve",
                 "mfu.decode", "paged_roofline.decode"):
        assert reader(name)(empty) is None, name
    # spans but no kernel in the trace: no share of a roofline
    assert reader("flash_roofline.prefill")(
        {"sizes": MISTRAL, "family": dense, "spans": ADDS,
         "trace": Trace()}) is None


def test_train_readers_from_the_step_spans():
    from bench.harness.cell import reader
    spans = [("pipeline.next", 0.0, 0.001, 0), ("train_step", 0.001, 1.7, 0),
             ("pipeline.next", 1.7, 1.702, 0), ("train_step", 1.702, 3.5, 0)]
    ctx = {"sizes": SMOLLM, "family": dense, "spans": spans, "steps": 2,
           "window_start": 0.0, "step_ends": [1.7, 3.5],
           "batch": 8, "seq_len": 2048, "accum_steps": 2}
    assert reader("step_ms.train")(ctx) == pytest.approx(1750, rel=1e-9)
    assert reader("data_wait_ms.train")(ctx) == pytest.approx(1.5,
                                                               rel=1e-9)
    assert reader("mfu.train")(ctx) == pytest.approx(
        100 * 2 * dense.train_flops(SMOLLM, 8, 2048) / (3.5 * 989e12),
        rel=1e-12)
