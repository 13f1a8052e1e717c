#!/usr/bin/env python
"""Decode-core A/B on the GPU: the Hopper kernel ('cuda') against the XLA
scan core ('xla'), end to end through ViterbiTPU.run, plus a dec_len sweep
and a profiler trace of each core.

    python scripts/core_ab.py [--out chiprun_out/core_ab.json]
                              [--trace-dir chiprun_out/traces]

Timing: wall clock around one run() (input device resident, output
blocked on), REPEATS runs per core, the two cores alternating which goes
first; median and quartiles.  Trace: three decodes of SOFT8/b32 at 32M
bits per core under jax.profiler; kernels are the events on the device
plane's stream lines; busy time is their union over the window from the
first kernel's start to the last kernel's end.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 10


def stats(ts):
    ts = np.asarray(ts)
    return {"median_s": float(np.median(ts)),
            "q1_s": float(np.percentile(ts, 25)),
            "q3_s": float(np.percentile(ts, 75)), "n": int(ts.size)}


def workload(cfg, n_bits, seed):
    import jax

    from tpu_viterbi.chain import packed_workload
    from tpu_viterbi.sharding.simulate import DEFAULT_SCALES
    _, packed = jax.jit(lambda k: packed_workload(
        k, n_bits, cfg.channel_in, 5.5,
        DEFAULT_SCALES[cfg.channel_in]))(jax.random.PRNGKey(seed))
    return jax.block_until_ready(packed[:cfg.get_input_words(2 * n_bits)])


def ab(cfg, n_bits, dec_len, cores=("xla", "cuda")):
    """{core: timing stats} for run() of one workload; checks equality."""
    from tpu_viterbi.decoder.api import ViterbiTPU
    x = workload(cfg, n_bits, 1)
    decs = {c: ViterbiTPU(cfg, dec_len=dec_len, backend=c) for c in cores}
    outs = {c: d.run(x, 2 * n_bits, want_time=False)[0]
            for c, d in decs.items()}
    first = outs[cores[0]]
    equal = all(np.array_equal(first, o) for o in outs.values())
    times = {c: [] for c in cores}
    for rep in range(REPEATS):
        order = cores if rep % 2 == 0 else cores[::-1]
        for c in order:
            times[c].append(decs[c].run(x, 2 * n_bits)[1])
    m = cfg.get_message_len(2 * n_bits)
    res = {"equal": equal, "message_bits": m, "dec_len": dec_len}
    for c in cores:
        res[c] = stats(times[c])
        res[c]["gbps"] = m / res[c]["median_s"] / 1e9
    return res


def trace(cfg, n_bits, dec_len, core, trace_dir):
    import jax

    from tpu_viterbi.decoder.api import ViterbiTPU
    x = workload(cfg, n_bits, 2)
    dec = ViterbiTPU(cfg, dec_len=dec_len, backend=core)
    dec.run(x, 2 * n_bits, want_time=False)
    d = os.path.join(trace_dir, core)
    runs = 3
    with jax.profiler.trace(d):
        for _ in range(runs):
            dec.run(x, 2 * n_bits, want_time=False)
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    lines, evs = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            le = [(e.start_ns, e.end_ns, e.name) for e in line.events]
            lines[f"{plane.name} | {line.name}"] = len(le)
            if line.name.startswith("Stream"):
                evs += le
    evs.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in evs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (evs[-1][1] - evs[0][0]) if evs else 0.0
    by_name = {}
    for s, e, n in evs:
        t = by_name.setdefault(n, [0, 0.0])
        t[0] += 1
        t[1] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    plan = dec._plan
    return {"core": core, "dec_len": dec_len, "runs": runs,
            "kernel_launches_per_run": len(evs) / runs,
            "launches_per_stage": len(evs) / runs / plan.block_len,
            "window_s": window / 1e9, "busy_s": busy / 1e9,
            "idle_share": 1 - busy / window if window else None,
            "top_kernels": [{"name": n[:120], "count": c, "total_s": t / 1e9}
                            for n, (c, t) in top],
            "lines": lines}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="chiprun_out/core_ab.json")
    p.add_argument("--trace-dir", default="chiprun_out/traces")
    args = p.parse_args()

    from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig
    from tpu_viterbi.decoder.api import DEFAULT_DEC_LEN
    from tpu_viterbi.utils.cache import enable_compile_cache
    from tpu_viterbi.utils.device import (card_name_and_power_limit,
                                          require_gpu)
    res = {"device": require_gpu(), "card": card_name_and_power_limit(),
           "ab": [], "sweep": [], "traces": []}
    enable_compile_cache()
    print(res["card"], flush=True)
    t0 = time.time()

    soft8 = DecoderConfig(channel_in=ChannelIn.SOFT8)
    for n_bits in (32_000_000, 1_000_000):
        for dl in (256, 512, 1024, 2048, 4096, 8192):
            cores = ("cuda", "xla") if dl in (2048, 8192) else ("cuda",)
            r = ab(soft8, n_bits, dl, cores)
            r["config"] = "SOFT8/b32"
            res["sweep"].append(r)
            print(f"[{time.time() - t0:6.1f}s] sweep {n_bits} dl={dl} " +
                  " ".join(f"{c} {r[c]['median_s'] * 1e3:.3f} ms"
                           for c in cores), flush=True)

    for n_bits in (32_000_000, 1_000_000):
        for ch in (ChannelIn.SOFT8, ChannelIn.HARD, ChannelIn.SOFT16,
                   ChannelIn.FP32):
            for out in (DecodeOut.O_B32, DecodeOut.O_B16):
                cfg = DecoderConfig(channel_in=ch, decode_out=out)
                r = ab(cfg, n_bits, DEFAULT_DEC_LEN)
                r["config"] = f"{ch.name}/{out.name}"
                res["ab"].append(r)
                print(f"[{time.time() - t0:6.1f}s] {r['config']} {n_bits} "
                      f"equal={r['equal']} xla "
                      f"{r['xla']['median_s'] * 1e3:.3f} ms cuda "
                      f"{r['cuda']['median_s'] * 1e3:.3f} ms", flush=True)

    for core in ("xla", "cuda"):
        tr = trace(soft8, 32_000_000, DEFAULT_DEC_LEN, core, args.trace_dir)
        res["traces"].append(tr)
        print(f"[{time.time() - t0:6.1f}s] trace {core}: "
              f"{tr['kernel_launches_per_run']:.0f} launches/run, "
              f"idle {tr['idle_share']}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"ok": all(r["equal"] for r in res["ab"] + res["sweep"]),
                      "out": args.out}))


if __name__ == "__main__":
    main()
