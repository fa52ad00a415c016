#!/usr/bin/env python
"""Microbenchmark: the tri-plane sample's gather and the fine-plane
gradient scatter-add, at Replica room0 scale, on one GPU.

    python -m myslam_torch.tools.bench_scatter [--n 160000] [--iters 20] \
        [--gather]

The port of ``myslam_tpu/tools/bench_scatter.py``, with the same
labelled lines (name, ms by CUDA events, rel_err = max |error| over
max |reference|):

  * ``--gather``: the forward sample on the room0 SDF (0.06 m) and color
    (0.03 m) atlases, c_dim 32, points uniform in [-1, 1], atlas
    N(0, 0.01^2).  ``plain_f32`` (the plain PyTorch version on the f32
    quad, the reference line, as XLA's was in the JAX tool),
    ``smem_bf16`` (K3 on the bf16 quad; also held against K1 and the
    plain version on the same bf16 quad) and ``k1_f32`` (K1 on the f32
    quad).  K3 prints "skipped" only where its cluster planner finds the
    coarse level too large.
  * the scatter: 160,000 updates of width 128 into the room0 fine-plane
    row counts, by ``index_add_`` (f32, bf16, sorted), ``scatter_add_``
    (the segment sum; unsorted, sorted) and, for 20,000 rows or fewer,
    a bf16 one-hot product.  These library calls are the yardsticks of
    this tool; the SLAM path never calls them.

The run goes on the GPU unless ``--device cpu`` is given; on the CPU the
kernels' plain versions run and nothing is timed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from myslam_torch import resolve_device
from myslam_torch.models.planes import make_layout
from myslam_torch.ops.cuda_sample import plane_sample_fwd, \
    plane_sample_fwd_ref
from myslam_torch.ops.plane_sample import pack_quad
from myslam_torch.ops.smem_sample import LAST_LAUNCH, make_sample_quad_smem

# Replica room0's bound (configs/Replica/room0.yaml), float32 as in the
# JAX tool.
ROOM0_BOUND = np.array([[-1.9, 8.18], [-2.2, 4.58], [-2.5, 2.78]],
                       np.float32)
GATHER_LAYOUTS = (([0.24, 0.06], "sdf-atlas(0.06m)"),
                  ([0.24, 0.03], "color-atlas(0.03m)"))
C_DIM = 32
# room0-scale fine planes: SDF ~164x112, color ~328x224.
SCATTER_ROWS = ((18_368, "sdf-fine"), (73_472, "color-fine"))
SCATTER_WIDTH = 128
ONEHOT_MAX_ROWS = 20_000


def time_ms(fn, iters: int, device: torch.device):
    """Mean ms of fn() by CUDA events after two warm-up calls; None off
    the GPU (a CPU time is not a device time)."""
    if device.type != "cuda" or iters < 1:
        return None
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / (ref.abs().max() + 1e-9))


def format_line(rec: dict) -> str:
    if "skipped" in rec:
        return f"{rec['name']:22s} skipped: {rec['skipped']}"
    ms = ("not timed" if rec["ms"] is None else f"{rec['ms']:8.3f} ms")
    line = f"{rec['name']:22s} {ms}  rel_err={rec['rel_err']:.2e}"
    if "rel_err_vs_k1_bf16" in rec:
        line += (f"  vs_k1_bf16={rec['rel_err_vs_k1_bf16']:.2e}"
                 f"  cluster={rec['cluster_blocks']}"
                 f"  grid={rec['grid_blocks']}")
    return line


def bench_gather(n: int, iters: int, device, seed: int = 0,
                 log=print) -> list[dict]:
    """The forward gather lines on both room0 atlases; one record each."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    records = []
    for res, label in GATHER_LAYOUTS:
        layout = make_layout(ROOM0_BOUND, res, C_DIM)
        atlas = 0.01 * torch.randn((layout.total_rows, C_DIM),
                                   generator=gen, device=device)
        quad = pack_quad(atlas, layout)
        p_nor = torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0
        log(f"--- gather {label}: {layout.total_rows} rows "
            f"({layout.total_rows * 4 * C_DIM * 2 / 1e6:.1f} MB bf16 quad), "
            f"{n} points ---")
        base = {"section": "gather", "atlas": label,
                "rows": layout.total_rows, "points": n}

        def add(rec):
            records.append({**base, **rec})
            log(format_line(rec))

        with torch.no_grad():
            ref = plane_sample_fwd_ref(quad, layout, p_nor)
            add({"name": "plain_f32", "rel_err": 0.0,
                 "ms": time_ms(lambda: plane_sample_fwd_ref(
                     quad, layout, p_nor), iters, device)})
            try:
                smem = make_sample_quad_smem(layout, n)
            except ValueError as e:
                add({"name": "smem_bf16", "skipped": "coarse level exceeds "
                     f"cluster shared memory ({e})"})
            else:
                quad16 = quad.to(torch.bfloat16)
                got = smem(quad16, p_nor)
                k1_16 = plane_sample_fwd(quad16, layout, p_nor)
                plain16 = plane_sample_fwd_ref(quad16, layout, p_nor)
                add({"name": "smem_bf16", "rel_err": rel_err(got, ref),
                     "rel_err_vs_k1_bf16": rel_err(got, k1_16),
                     "rel_err_vs_plain_bf16": rel_err(got, plain16),
                     **{k: LAST_LAUNCH.get(k) for k in
                        ("cluster_blocks", "grid_blocks")},
                     "ms": time_ms(lambda: smem(quad16, p_nor), iters,
                                   device)})
            got = plane_sample_fwd(quad, layout, p_nor)
            add({"name": "k1_f32", "rel_err": rel_err(got, ref),
                 "ms": time_ms(lambda: plane_sample_fwd(quad, layout, p_nor),
                               iters, device)})
    return records


def scatter_strategies(rows: int, device) -> list:
    """(name, fn(cell int64 (n,), upd f32 (n, 128)) -> (rows, 128) f32)
    for every scatter strategy; index_add_ in f32 first, the reference."""
    device = torch.device(device)

    def zeros(dtype=torch.float32):
        return torch.zeros((rows, SCATTER_WIDTH), dtype=dtype, device=device)

    def index_add_f32(cell, upd):
        return zeros().index_add_(0, cell, upd)

    def index_add_bf16(cell, upd):
        return zeros(torch.bfloat16).index_add_(
            0, cell, upd.to(torch.bfloat16)).float()

    def sorted_index_add(cell, upd):
        order = torch.argsort(cell)
        return zeros().index_add_(0, cell[order], upd[order])

    def scatter_add(cell, upd):
        return zeros().scatter_add_(0, cell[:, None].expand_as(upd), upd)

    def scatter_add_sorted(cell, upd):
        order = torch.argsort(cell)
        cs = cell[order]
        return zeros().scatter_add_(0, cs[:, None].expand_as(upd),
                                    upd[order])

    def onehot_bf16(cell, upd):
        oh = (cell[:, None] == torch.arange(rows, device=device)[None, :]
              ).to(torch.bfloat16)
        return (oh.t() @ upd.to(torch.bfloat16)).float()

    cands = [("index_add_f32", index_add_f32),
             ("index_add_bf16", index_add_bf16),
             ("sorted_index_add", sorted_index_add),
             ("scatter_add", scatter_add),
             ("scatter_add_sorted", scatter_add_sorted)]
    if rows <= ONEHOT_MAX_ROWS:
        cands.append(("onehot_bf16", onehot_bf16))
    return cands


def bench_scatter(n: int, iters: int, device, seed: int = 0,
                  log=print) -> list[dict]:
    """The scatter lines for both room0 fine-plane row counts."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    records = []
    for rows, label in SCATTER_ROWS:
        cell = torch.randint(0, rows, (n,), generator=gen, device=device)
        upd = torch.randn((n, SCATTER_WIDTH), generator=gen, device=device)
        log(f"--- {label}: {rows} rows, {n} updates ---")
        ref = None
        for name, fn in scatter_strategies(rows, device):
            got = fn(cell, upd)
            ref = got if ref is None else ref
            rec = {"name": name, "rel_err": rel_err(got, ref),
                   "ms": time_ms(lambda: fn(cell, upd), iters, device)}
            records.append({"section": "scatter", "target": label,
                            "rows": rows, "updates": n, **rec})
            log(format_line(rec))
    return records


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=160_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--gather", action="store_true",
                    help="also run the forward-gather comparison "
                         "(K1 vs K3)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(torch.cuda.get_device_name(device), flush=True)
    records = []
    if args.gather:
        records += bench_gather(args.n, args.iters, device)
    records += bench_scatter(args.n, args.iters, device)
    return records


if __name__ == "__main__":
    main()
