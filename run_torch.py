#!/usr/bin/env python3
"""Run the PyTorch/CUDA SLAM system on a config: the loop, the periodic
and final checkpoints and meshes; print its ATE.

    python run_torch.py configs/Synthetic/room.yaml            # on the GPU
    python run_torch.py configs/Synthetic/room_smoke.yaml --device cpu
    python run_torch.py configs/Replica/room0.yaml --input_folder DIR \\
        --output OUT --supervise

The run goes on the GPU unless ``--device cpu`` is given; without a GPU
and without that flag it stops with an error.  ``--input_folder`` and
``--output`` override the config's ``data.input_folder`` and
``data.output``; ``--resume`` continues from the newest checkpoint under
``<output>/ckpts``.  The last line of the output is one JSON object with
the ATE, the frame count, the frame the run started from
(``resumed_from``, 0 when fresh), the output folder and the culled
mesh's path.  A failure of the checkpoint or the mesh raises.

``--supervise`` runs the job as a child process and restarts it from
the newest checkpoint (``--resume``) when it dies, or, with
``--hang-timeout S``, when ``<output>/HEARTBEAT`` has not changed for S
seconds, at most ``--max-restarts`` times; it prints ``SUPERVISOR: ...``
lines and exits 0 only when a child completes, after which it repeats
the completed child's JSON line as its own last line.

``--launch N`` runs the job as a gang of N ranks, one process and one
device each (rank r on ``cuda:(r % device_count)``, or all on the CPU
with ``--device cpu``), for configs whose ``parallel.devices`` or
``parallel.kf_shards`` is N or 0: the kernels are built once, then N
copies of this script start with ``--nproc N --procid r --coordinator
host:port``; the launcher polls them and, when one exits abnormally,
kills the others and exits with its code.  Ranks share a GPU over gloo
and use NCCL when each has its own (``parallel/distributed.py``).  Rank
0 alone writes the outputs and prints the JSON line; every other rank
prints ``RANK r: resumed_from S``.  Under ``--supervise --launch N`` a
death of any rank restarts the whole gang from rank 0's newest
checkpoint; ``MYSLAM_FAULT_KILL="<frame>:<rank>"`` kills one rank once.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--input_folder", default=None,
                   help="overrides the config's data.input_folder")
    p.add_argument("--output", default=None,
                   help="overrides the config's data.output")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in the output "
                        "folder (the full state, map included)")
    gang = p.add_argument_group("multi-process gang")
    gang.add_argument("--launch", type=int, default=1,
                      help="run as a gang of N ranks on this machine")
    gang.add_argument("--nproc", type=int, default=1,
                      help="ranks in the gang (set by --launch)")
    gang.add_argument("--procid", type=int, default=0,
                      help="this process's rank (set by --launch)")
    gang.add_argument("--coordinator", default=None,
                      help="host:port of rank 0 (set by --launch)")
    sup = p.add_argument_group("failure detection and restart")
    sup.add_argument("--supervise", action="store_true",
                     help="run the job as a child and restart it from the "
                          "newest checkpoint when it dies or hangs")
    sup.add_argument("--max-restarts", type=int, default=3,
                     help="restarts before the supervisor gives up "
                          "(default 3)")
    sup.add_argument("--hang-timeout", type=float, default=0.0,
                     help="seconds without a HEARTBEAT change before the "
                          "job counts as hung (0: exit codes only; allow "
                          "for frame 0 and the kernels' build)")
    return p.parse_args(argv)


def main(argv=None) -> dict | int:
    args = parse_args(argv)
    if args.supervise:
        return supervise(args)
    if args.launch > 1:
        return launch_local(args)

    import torch

    from myslam_torch.parallel import distributed

    device = args.device
    if args.nproc > 1:
        if not (0 <= args.procid < args.nproc) or not args.coordinator:
            raise SystemExit("--nproc needs --procid in [0, nproc) and "
                             "--coordinator host:port (--launch N sets "
                             "them)")
        distributed.init_distributed(args.coordinator, args.nproc,
                                     args.procid, args.device)
        device = distributed.rank_device(args.procid, args.device)
        # The ranks share this machine's cores.
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1)
                                         // args.nproc)))
    try:
        return run(args, device)
    finally:
        distributed.shutdown()


def run(args, device) -> dict | None:
    """The job of one process: the loop, finalize, and (rank 0) the JSON
    line, with this process's K1/K2 launches over the two (``launches``;
    every other rank prints its own on a ``RANK r: launches`` line)."""
    from myslam_torch.engine.scheduler import SLAMSystem
    from myslam_torch.ops import cuda_sample
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    cfg = load_config(args.config, DEFAULT_CONFIG)
    t0 = time.perf_counter()
    slam = SLAMSystem(cfg, input_folder=args.input_folder,
                      output=args.output, seed=args.seed, device=device)
    start = slam.resume() if args.resume else 0
    if not slam.proc0:
        print(f"RANK {slam.rank}: resumed_from {start}", flush=True)
    cuda_sample.reset_launches()
    slam.run(start)
    t_end = time.perf_counter()
    launches = dict(cuda_sample.LAUNCHES)
    if not slam.proc0:
        print(f"RANK {slam.rank}: launches {json.dumps(launches)}",
              flush=True)
        return None
    ate = slam.ate()
    out = {
        "device": str(slam.device),
        "frames": slam.n_img,
        "resumed_from": start,
        "output": slam.output,
        "ate_rmse_cm": ate["absolute_translational_error.rmse"] * 100.0,
        "wall_s": slam.drain_wall - t0,
        "final_mesh": slam.final_mesh,
        "finalize_s": t_end - slam.drain_wall,
        "launches": launches,
    }
    print(json.dumps(out), flush=True)
    return out


def launch_local(args) -> int:
    """Start ``args.launch`` ranks of this script on this machine and
    wait for them (``multiproc.wait_gang``: the first abnormal exit
    kills the rest and is returned)."""
    from myslam_torch.parallel.multiproc import free_port, prebuild, \
        wait_gang

    prebuild(args.device)
    base = [sys.executable, os.path.abspath(__file__), args.config,
            "--seed", str(args.seed), "--nproc", str(args.launch),
            "--coordinator", f"127.0.0.1:{free_port()}"]
    for flag, value in (("--input_folder", args.input_folder),
                        ("--output", args.output),
                        ("--device", args.device)):
        if value:
            base += [flag, value]
    if args.resume:
        base.append("--resume")
    procs = [subprocess.Popen(base + ["--procid", str(r)])
             for r in range(args.launch)]
    try:
        rc, _ = wait_gang(procs)
    except BaseException:
        for pr in procs:
            pr.kill()
        raise
    return rc


def _output_dir(args) -> str:
    if args.output:
        return args.output
    from myslam_torch.utils.config import DEFAULT_CONFIG, load_config

    return load_config(args.config, DEFAULT_CONFIG)["data"]["output"]


def _pump(pipe, lines: list) -> None:
    """Copy a child's output to ours, keeping its lines."""
    for line in pipe:
        sys.stdout.write(line)
        sys.stdout.flush()
        lines.append(line)


def supervise(args) -> int:
    """Run the job as a child process group and restart it from the
    newest checkpoint when it fails: a nonzero exit, or (``hang_timeout``
    > 0) no change of ``<output>/HEARTBEAT`` for that many seconds, after
    which the group is killed.  At most ``max_restarts`` restarts;
    returns 0 once a child completes, else the last child's exit code.
    The children's output passes through; the completed child's JSON line
    is printed again last.  The checkpoints are crash-atomic, so a kill
    during a write leaves the previous one to resume from."""
    hb = os.path.join(_output_dir(args), "HEARTBEAT")
    base = [sys.executable, os.path.abspath(__file__), args.config,
            "--seed", str(args.seed)]
    for flag, value in (("--input_folder", args.input_folder),
                        ("--output", args.output),
                        ("--device", args.device)):
        if value:
            base += [flag, value]
    if args.launch > 1:
        base += ["--launch", str(args.launch)]
    restarts = 0
    while True:
        resume = args.resume or restarts > 0
        child = subprocess.Popen(base + (["--resume"] if resume else []),
                                 start_new_session=True,
                                 stdout=subprocess.PIPE, text=True)
        lines: list[str] = []
        pump = threading.Thread(target=_pump, args=(child.stdout, lines))
        pump.start()
        t_start = time.time()
        hung = False
        try:
            while True:
                rc = child.poll()
                if rc is not None:
                    break
                if args.hang_timeout > 0:
                    try:
                        last = os.path.getmtime(hb)
                    except OSError:
                        last = t_start
                    if time.time() - max(last, t_start) > args.hang_timeout:
                        hung = True
                        print("SUPERVISOR: no heartbeat for "
                              f"{args.hang_timeout:.0f}s — killing the job",
                              flush=True)
                        os.killpg(child.pid, signal.SIGKILL)
                        rc = child.wait()
                        break
                time.sleep(0.5)
        except BaseException:
            # The supervisor itself is stopping: take the job with it.
            os.killpg(child.pid, signal.SIGKILL)
            child.wait()
            raise
        finally:
            pump.join()
        if rc == 0 and not hung:
            if restarts:
                print(f"SUPERVISOR: completed after {restarts} "
                      "restart(s)", flush=True)
            result = [ln for ln in lines if ln.startswith("{")]
            if result:
                print(result[-1], end="", flush=True)
            return 0
        if restarts >= args.max_restarts:
            print(f"SUPERVISOR: giving up after {restarts} restart(s) "
                  f"(rc={rc})", flush=True)
            return rc or 1
        restarts += 1
        kind = "hung" if hung else f"died (rc={rc})"
        print(f"SUPERVISOR: job {kind} — restart "
              f"{restarts}/{args.max_restarts} from the newest "
              "checkpoint", flush=True)


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
