"""Find a serving cell's knee: the highest arrival rate at which the
backlog does not grow over the window.

    python3 bench/sweep.py --workload <cell> --seconds <s> \\
        --rates 2,3,4,5 --seed <n>

One process, one engine: for each rate the cell's open-loop mix runs a
window at that rate (after its warm-up's arrivals at that rate), and the
requests in the system (due and waiting, or running) are counted at each
admission and decode step.
The backlog grows where a line fitted to the counts over the window
rises by more than a quarter of their mean, or where the window completes
fewer than 95 % of the output tokens the schedule offers it.  The cell's
traffic file then takes 0.8 × the knee.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import numpy as np
    import torch
    from bench.harness import cell, family, serve, traffic, weights

    w = next(x for x in cell.benchmark()["workloads"]
             if x["name"] == args.workload)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    config = weights.load_config(w["config"])
    device = torch.device("cuda", 0)
    base = traffic.load(w["traffic"])
    fam = family.of(config)
    m = fam.sizes(config)
    _, eng = serve.build(fam, m, config, args.seed, device)

    class Counted(serve.Server):
        queue: list = []
        counts: list = []

        def count(self):
            now = time.perf_counter()
            waiting = sum(1 for due, _ in self.queue if due <= now)
            self.counts.append((now, waiting + len(self.live)))

        def _step(self):
            self.count()
            return super()._step()

        def _admit(self, r, due):
            self.count()
            return super()._admit(r, due)

    for rate in (float(r) for r in args.rates.split(",")):
        mix = traffic.serve_mix({**base, "rate_per_s": rate}, m["vocab"],
                                args.seed, args.seconds)
        srv = Counted(eng, mix, config["serving"]["page_tokens"])
        srv.counts = []
        start, srv.queue = serve.warm_up(srv)
        srv.counts = []
        srv.record = True
        end = start + args.seconds
        srv.drive(srv.queue, end)
        n = serve.metrics(srv, start, end, srv.queue)
        c = np.array(srv.counts)
        c = c[c[:, 0] >= start]
        slope = np.polyfit(c[:, 0] - start, c[:, 1], 1)[0]
        rise = slope * args.seconds
        offered = rate * np.mean([r.max_new for r in mix.requests])
        done = n["tokens"] / args.seconds
        grows = bool(rise > 0.25 * c[:, 1].mean() or done < 0.95 * offered)
        print("[sweep] " + json.dumps({
            "rate_per_s": rate, "due": n["due"],
            "ttft_p90_ms": cell.percentile(n["ttft_ms"] + n["late_ms"], 90),
            "itl_p95_ms": cell.percentile(n["itl_ms"], 95),
            "output_tok_s": n["tokens"] / args.seconds,
            "offered_tok_s": offered,
            "in_system_mean": float(c[:, 1].mean()),
            "in_system_rise": float(rise),
            "waiting_at_end": sum(1 for d, _ in srv.queue if d < end),
            "grows": grows}), flush=True)
        for sid in list(srv.live):
            eng.release(sid)
        for sid in srv.roots:
            eng.release(sid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
