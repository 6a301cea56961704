"""Traffic is a function of the seed: the same seed gives the same
requests, another seed the same sizes in the same order, with other
tokens."""
import hashlib

import numpy as np
import pytest

from bench.harness import traffic
from bench.tests import smoke


def sizes(mix):
    reqs = mix.warmup + mix.requests
    return [sorted(r.prefix for r in reqs), sorted(len(r.suffix)
                                                   for r in reqs),
            sorted(r.max_new for r in reqs)]


@pytest.mark.parametrize("name", ["serve.prefix-chat"])
def test_serve_mix_is_a_function_of_the_seed(name):
    spec = traffic.load(name)
    a, b = (traffic.serve_mix(spec, 32768, smoke.SEED, 40)
            for _ in range(2))
    c = traffic.serve_mix(spec, 32768, smoke.SEED + 1, 40)
    for x, y in zip(a.requests + a.warmup, b.requests + b.warmup):
        assert (x.prefix, x.max_new, x.due) == (y.prefix, y.max_new, y.due)
        assert np.array_equal(x.suffix, y.suffix)
    assert all(np.array_equal(p, q) for p, q in zip(a.prefixes, b.prefixes))
    # another seed: the same work in the same order, and other tokens
    assert sizes(a) == sizes(c)
    assert [(r.prefix, len(r.suffix), r.max_new, r.due)
            for r in a.warmup + a.requests] == \
        [(r.prefix, len(r.suffix), r.max_new, r.due)
         for r in c.warmup + c.requests]
    assert not np.array_equal(a.prefixes[0], c.prefixes[0])


def test_open_loop_window_holds_its_rate_and_shares():
    spec = traffic.load("serve.prefix-chat")
    mix = traffic.serve_mix(spec, 32768, smoke.SEED, 40)
    due = np.array([r.due for r in mix.requests])
    assert len(mix.requests) == round(spec["rate_per_s"] * 40)
    assert due[0] == 0 and np.all(np.diff(due) > 0) and due[-1] < 45
    assert all(r.due < 0 for r in mix.warmup)
    counts = np.bincount([r.prefix for r in mix.warmup + mix.requests])
    shares = [p["share"] for p in spec["prefixes"]]
    assert np.allclose(counts / counts.sum(), shares, atol=0.01)


def test_corpus_is_a_function_of_the_seed():
    a = traffic.corpus(512, 16, 65, smoke.SEED)
    assert np.array_equal(a, traffic.corpus(512, 16, 65, smoke.SEED))
    assert not np.array_equal(a, traffic.corpus(512, 16, 65, 1))
    assert a.min() >= 0 and a.max() < 512


def test_the_chat_mix_draws_the_requests_it_drew_before():
    # a digest of the full and the small chat mix's prompts and requests,
    # taken from the generator before a mix could go without prefixes
    h = hashlib.sha256()
    for spec in (traffic.load("serve.prefix-chat"), smoke.mix(smoke.SERVE)):
        mix = traffic.serve_mix(spec, 32768, smoke.SEED, 51)
        for p in mix.prefixes:
            h.update(p.tobytes())
        for r in mix.warmup + mix.requests:
            h.update(repr((r.prefix, r.max_new, r.due)).encode())
            h.update(r.suffix.tobytes())
    assert h.hexdigest() == \
        "419c245860791c67fe921bb79471d2e4be876409eb772831ff799b022ee499fb"


def test_a_mix_without_prefixes_draws_whole_prompts_from_the_suffix():
    spec = traffic.load("serve.prefix-chat")
    shared = traffic.serve_mix(spec, 32768, smoke.SEED, 40)
    alone = traffic.serve_mix({**spec, "prefixes": []}, 32768, smoke.SEED,
                              40)
    assert alone.prefixes == []
    reqs = alone.warmup + alone.requests
    before = shared.warmup + shared.requests
    assert all(r.prefix is None for r in reqs)
    # the same schedule and sizes: only the prefixes are gone
    assert [(len(r.suffix), r.max_new, r.due) for r in reqs] == \
        [(len(r.suffix), r.max_new, r.due) for r in before]
