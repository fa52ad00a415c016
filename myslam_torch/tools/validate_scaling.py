#!/usr/bin/env python
"""The scaling model's communication term, counted on a gang.

    python -m myslam_torch.tools.validate_scaling [--devices 2,4]
        [--smoke] [--device cpu] [--json]

The counterpart of ``myslam_tpu/tools/validate_scaling.py``, which reads
the collectives XLA compiled into a ray-DP mapping step out of its HLO.
The port's collectives are its own calls, so this runs one iteration of
a mapping window on a gang of n ranks
(``multiproc.run_scaling_window``), ray DP with the replicated Adam
(``shardmap``) and then with the ``dp_impl: spmd`` draws and the
row-sharded Adam (``spmd_zero``), and reads ``distributed.COUNTS``
(JAX's tool compiles one iteration too).  It prints each kind's bytes
and their ratio to the model's payload
(``scaling_report.atlas_grad_bytes``), and the bytes each rank
puts on the link: 2 (n-1) / n of an all-reduce's payload, (n-1) / n of a
reduce-scatter's input and of an all-gather's output.

  * plain DP: one all-reduce of the flat gradient (``grad``), the
    model's payload plus the window poses: ratio 1.00;
  * ZeRO: the reduce-scatter of the sharded atlas rows (``grad_rs``),
    the all-reduce of the replicated decoders and poses (``grad``) and
    the all-gather of the updated atlas rows (``zero_gather``).

``--smoke``: ``configs/Synthetic/room_smoke.yaml`` (120x160 imagery,
1,024 rays, the room's atlases); else ``room.yaml``.  Ranks run on their
GPUs unless ``--device cpu``; ranks sharing one card talk through gloo.
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def op_of(kind: str) -> str:
    """The collective a counted kind is."""
    return {"zero_gather": "all-gather",
            "grad_rs": "reduce-scatter"}.get(kind, "all-reduce")


def row(counts: dict, iters: int, world: int, backend: str | None,
        model_bytes: int, impl: str) -> dict:
    """One impl's collectives per iteration (``counts``:
    ``distributed.COUNTS`` over ``iters`` mapping iterations of a gang of
    ``world`` ranks) against the model's payload."""
    n = world
    ring = 2.0 * (n - 1) / n
    per_iter = {k: v["bytes"] / iters for k, v in counts.items()}
    share = {"all-reduce": ring, "reduce-scatter": ring / 2,
             "all-gather": ring / 2}
    wire = sum(b * share[op_of(k)] for k, b in per_iter.items())
    return {"n": n, "impl": impl, "backend": backend,
            "ops": {k: op_of(k) for k in per_iter},
            "calls_per_iter": {k: v["calls"] / iters
                               for k, v in counts.items()},
            "bytes_per_iter": per_iter,
            "ratio_vs_model": {k: b / model_bytes
                               for k, b in per_iter.items()},
            "wire_bytes_per_iter": wire,
            "model_wire_bytes": model_bytes * ring,
            "wire_ratio_vs_model": wire / (model_bytes * ring)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="2,4")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: each rank's GPU; 'cpu' to rehearse")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from myslam_torch.parallel import multiproc
    from myslam_torch.tools.scaling_report import atlas_grad_bytes
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    config = os.path.join(REPO, "configs", "Synthetic",
                          "room_smoke.yaml" if args.smoke else "room.yaml")
    model_bytes = atlas_grad_bytes(load_config(config, DEFAULT_CONFIG))
    rows = []
    for n in (int(x) for x in args.devices.split(",")):
        recs = multiproc.launch(n, loop="scaling", frames=1,
                                device=args.device, config=config,
                                timeout=900)
        r0 = recs[0]
        for rec in recs[1:]:
            for impl in ("plain", "zero"):
                calls = {k: v["calls"] for k, v in rec[impl].items()}
                if calls != {k: v["calls"] for k, v in r0[impl].items()}:
                    raise RuntimeError(f"ranks disagree on {impl}: {calls}")
        for impl, key in (("shardmap", "plain"), ("spmd_zero", "zero")):
            rows.append({**row(r0[key], r0["iters"], n, r0["backend"],
                               model_bytes, impl),
                         "atlas_bytes": r0["atlas_bytes"]})
    report = {"config": config, "model_grad_bytes": model_bytes,
              "rows": rows}
    if args.json:
        print(json.dumps(report))
    else:
        print(f"model payload: {model_bytes} B per iteration")
        for r in rows:
            print(f"n={r['n']} {r['impl']} ({r['backend']}): "
                  f"{r['bytes_per_iter']} B/iter, wire ratio "
                  f"{r['wire_ratio_vs_model']:.3f}")
    return report


if __name__ == "__main__":
    main()
