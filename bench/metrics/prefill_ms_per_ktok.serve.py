"""Milliseconds of ``Engine.add`` per thousand prompt tokens: the
benchmark's spans around each admission (prefill, page writes, the fork's
copy-on-write; it waits for the first token), over the prompts' tokens,
the shared prefix's with them."""


def read(ctx):
    adds = [s for s in ctx.get("spans", ()) if s[0] == "engine.add"]
    if not adds:
        return None
    return sum(t1 - t0 for _, t0, t1, *_ in adds) * 1e3 \
        / (sum(n for _, _, _, n, _ in adds) / 1e3)
