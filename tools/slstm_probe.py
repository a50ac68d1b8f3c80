#!/usr/bin/env python3
"""Probe the sLSTM kernel's two routes and its cluster planner on one card.

    python3 tools/slstm_probe.py [--out PATH.json]

Not part of the smoke run: it times what the design rests on, so that
``PERF.md`` can quote it.

1. The route crossover: both routes of ``kernels/slstm_scan.py`` in turns
   (cluster, per-row, per-row, cluster; cold L2) over P 8-64 at S 4096
   (B 1 H 1, B 4 H 4) and S 1 (B 4 H 4; a decode launch); the reduced
   xLSTM proxies run P 16.
2. Plans the planner passes over at (g) (B 4, S 4096, H 4, P 192) and (g')
   (B 128, S 512), timed beside its own plan.
3. Shapes whose clusters the card cannot hold at once (B 256 and H 16 at
   P 192): the planner's plan and its waves, held against the plain
   version and timed against the per-row route.
4. The card's cluster occupancy at P 192 for every (cs, bt) the planner
   weighs at B 4, 128 and 256 (``tests/test_torch_kernels.py`` states it
   as the H100's).

Prints the card's name and power limit and one JSON object, also written
to ``--out`` when given (relative to the repo's root).
"""
import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: (B, S, H, P) of the crossover sweep
CROSSOVER = [(b, s, h, p) for p in (8, 16, 32, 48, 64)
             for b, s, h in ((1, 4096, 1), (4, 4096, 4), (4, 1, 4))]
#: plans passed over, timed beside the planner's
PASSED_OVER = {"g": ((4, 4096, 4, 192), ((16, 2), (8, 4))),
               "g'": ((128, 512, 4, 192), ((16, 26), (16, 43)))}
#: shapes with more clusters than the card holds at once
MULTI_WAVE = {"B256 H4": (256, 512, 4, 192), "B4 H16": (4, 4096, 16, 192),
              "B128 H8": (128, 512, 8, 192)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("slstm_probe: no CUDA device", flush=True)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as SL
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = CS.ColdTimer(torch, reps=5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    launch = {"cluster": SL.launch_cluster, "per_row": SL.launch_per_row}

    def inputs(b, s, heads, p_dim):
        d = heads * p_dim
        gx = torch.randn((b, s, 4 * d), generator=gen, device="cuda")
        gx[..., 2 * d:3 * d] += 3.0                  # forget bias 3
        r = torch.randn((heads, p_dim, 4 * p_dim), generator=gen,
                        device="cuda") * p_dim ** -0.5
        return gx, r

    def in_turns(gx, r, reps):
        ms = {"cluster": [], "per_row": []}
        for name in ("cluster", "per_row", "per_row", "cluster"):
            ms[name].append(timer(lambda: launch[name](gx, r), reps=reps))
        return {k: sum(v) / 2 for k, v in ms.items()}

    def plan_of(b, heads, p_dim):
        cs, bt = SL.card_cluster_plan(b, heads, p_dim, 0)
        clusters = heads * -(-b // bt)
        resident = SL.max_clusters(0, p_dim, cs, bt)
        return {"cs": cs, "bt": bt, "clusters": clusters,
                "resident": resident, "waves": -(-clusters // resident)}

    out = {"card": smi, "crossover": {}, "passed_over": {},
           "multi_wave": {}, "occupancy_p192": {}}
    for b, s, heads, p_dim in CROSSOVER:
        gx, r = inputs(b, s, heads, p_dim)
        t = in_turns(gx, r, 5 if s > 1 else 50)
        tag = f"B{b} S{s} H{heads} P{p_dim}"
        out["crossover"][tag] = dict(t, rule=SL.route(p_dim),
                                     plan=plan_of(b, heads, p_dim))
        print(f"crossover {tag}: cluster {t['cluster']:.4f} ms, per-row "
              f"{t['per_row']:.4f} ms (rule {SL.route(p_dim)})", flush=True)

    for tag, ((b, s, heads, p_dim), alts) in PASSED_OVER.items():
        gx, r = inputs(b, s, heads, p_dim)
        plan = plan_of(b, heads, p_dim)
        row = {"plan": plan, "ms": timer(lambda: launch["cluster"](gx, r))}
        for alt in alts:
            row[f"{alt[0]},{alt[1]}"] = {
                "ms": timer(lambda: SL.launch_cluster(gx, r, plan=alt)),
                "clusters": heads * -(-b // alt[1]),
                "resident": SL.max_clusters(0, p_dim, *alt)}
        row["ms_again"] = timer(lambda: launch["cluster"](gx, r))
        out["passed_over"][tag] = row
        print(f"passed over ({tag}): {json.dumps(row)}", flush=True)

    for tag, (b, s, heads, p_dim) in MULTI_WAVE.items():
        gx, r = inputs(b, s, heads, p_dim)
        got, want = SL.launch_cluster(gx, r), ref.slstm_scan(gx, r, None)
        err = max(float((a - w).abs().max())
                  for a, w in zip((got[0], *got[1]), (want[0], *want[1])))
        ok = all(bool(torch.allclose(a, w, atol=2e-4, rtol=2e-4))
                 for a, w in zip((got[0], *got[1]), (want[0], *want[1])))
        t = in_turns(gx, r, 3)
        out["multi_wave"][tag] = dict(t, plan=plan_of(b, heads, p_dim),
                                      max_abs_err=err, within_tol=ok)
        print(f"multi-wave {tag} S{s}: {json.dumps(out['multi_wave'][tag])}",
              flush=True)

    bts = sorted({-(-b // g) for b in (4, 128, 256) for g in range(1, b + 1)})
    out["occupancy_p192"] = {
        f"{cs},{bt}": SL.max_clusters(0, 192, cs, bt)
        for cs in range(1, SL.MAX_CLUSTER + 1) for bt in bts
        if SL.plan_fits_block(192, cs, bt)}
    print(f"occupancy at P 192 (cs,bt: clusters at once): "
          f"{json.dumps(out['occupancy_p192'])}", flush=True)
    if args.out:
        path = ROOT / args.out
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0 if all(v["within_tol"] for v in out["multi_wave"].values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
