"""The mini-loop (``myslam_torch/parallel/multiproc.run_minislam``) in
both modes on a gang of 2 CPU ranks (``launch(2)``) against the JAX
package's ``run_minislam`` run in this process on 2 of the virtual CPU
devices: the same initial map and JAX's draws replayed (every rank
replays the same list, built from JAX's own key splits), the loss
weights doubled on the port's side because JAX's shard_map steps take
twice the global gradient on 2 devices (ROADMAP R5,
test_torch_parallel.py), so the port's losses are twice JAX's.

Tolerances, with their reason: the trajectory within 1e-4 and the
per-iteration losses within rtol 1e-4 over 6 frames of tracking and
mapping, where float sums over the ranks run in gloo's order and XLA's
in another and each frame starts from the last (the single steps hold
at 1e-5, test_torch_parallel.py).
"""

import types

import jax
import numpy as np
import pytest

import myslam_tpu.ops.plane_sample as jps
from myslam_tpu.engine.scheduler import compute_bound as j_compute_bound
from myslam_tpu.models.decoders import init_decoder_params
from myslam_tpu.models.planes import init_map_state, make_layout
from myslam_tpu.parallel import multiproc as jmultiproc
from myslam_torch.parallel import multiproc
from test_torch_parallel import LOSS_WEIGHTS
from test_torch_slice import render_draws

FRAMES = 6
RANKS = 2
# run_minislam's scene: 8 stratified + 4 importance samples, jitter on.
SCENE = types.SimpleNamespace(perturb=True, n_stratified=8, n_importance=4,
                              n_samples=12)


@pytest.fixture(autouse=True)
def _scatter_route(monkeypatch):
    monkeypatch.setattr(jps, "ONEHOT_MAX_ROWS", 0)


def minislam_draws(mode, cfg, key):
    """JAX's run_minislam draws in the order the port's loop takes them:
    per tracked frame its iterations' jitter at the global batch shape;
    per mapped frame, per iteration, ray DP's whole padded pixel batch
    and its local batch's renderer draws, or each kf shard's folded
    pixel draws stacked over the shards and the depth-guided jitter."""
    t, m = cfg["tracking"], cfg["mapping"]
    W, H = int(cfg["cam"]["W"]), int(cfg["cam"]["H"])
    n_rays = int(m["pixels"])
    out = []
    for f in range(FRAMES):
        if f > 0:
            kt = jax.random.fold_in(key, 2 * f)
            for it in range(int(t["iters"])):
                out += render_draws(jax.random.fold_in(kt, it),
                                    int(t["pixels"]), SCENE, False)
        if f % 2:
            continue
        km = jax.random.fold_in(key, 2 * f + 1)
        for it in range(int(m["iters_first" if f == 0 else "iters"])):
            k = jax.random.fold_in(km, it)
            if mode == "dp":
                rows = -(-n_rays // RANKS)
                k_px, k_render = jax.random.split(k)
                ki, kj = jax.random.split(k_px)
                out += [jax.random.randint(ki, (rows * RANKS,), 0, W),
                        jax.random.randint(kj, (rows * RANKS,), 0, H)]
                out += render_draws(k_render, rows, SCENE, True)
                continue
            n_local = n_rays // RANKS
            k_ray, k_z = jax.random.split(k)
            keys = [jax.random.split(jax.random.fold_in(k_ray, me))
                    for me in range(RANKS)]
            out += [np.stack([jax.random.randint(ki, (n_local,), 0, W)
                              for ki, _ in keys]),
                    np.stack([jax.random.randint(kj, (n_local,), 0, H)
                              for _, kj in keys]),
                    jax.random.uniform(k_z, (n_local, SCENE.n_samples))]
    return [np.asarray(d) for d in out]


def write_replay(path, mode, seed=0):
    """JAX's initial map and draws, as run_minislam's ``replay`` file."""
    cfg = jmultiproc.tiny_cfg(FRAMES, RANKS)
    bound = j_compute_bound(cfg)
    key = jax.random.PRNGKey(seed)
    ms = init_map_state(key, make_layout(bound, [0.48, 0.24], 8),
                        make_layout(bound, [0.48, 0.24], 8),
                        init_decoder_params(key, c_dim=8))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(ms.decoder)]
    packed = np.empty(len(leaves), dtype=object)
    packed[:] = leaves
    draws = minislam_draws(mode, cfg, key)
    np.savez(path, sdf_atlas=np.asarray(ms.sdf_atlas),
             color_atlas=np.asarray(ms.color_atlas), decoder_leaves=packed,
             n_draws=len(draws),
             **{f"draw_{k}": d for k, d in enumerate(draws)})


@pytest.mark.parametrize("mode", ["dp", "kf"])
def test_minislam_gang_matches_jax(tmp_path, monkeypatch, mode):
    """The port's mini-loop on 2 ranks against JAX's on 2 devices: the
    6-frame trajectory, the tracking losses and every mapping
    iteration's loss; both ranks agree bit for bit."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads
    path = str(tmp_path / "replay.npz")
    write_replay(path, mode)
    weights = {k: 2.0 * float(jmultiproc.tiny_cfg(FRAMES, RANKS)
                              ["mapping"][k]) for k in LOSS_WEIGHTS}
    outs = multiproc.launch(RANKS, mode=mode, frames=FRAMES, replay=path,
                            overrides={"mapping": weights}, timeout=240,
                            device="cpu")
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices[:RANKS])
    ref = jmultiproc.run_minislam(mode, FRAMES, seed=0, log=lambda m: None)
    for out in outs:
        for k in ("est", "track_losses", "map_losses"):
            np.testing.assert_array_equal(out[k], outs[0][k])
    got = outs[0]
    np.testing.assert_allclose(got["est"], ref["est"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["track_losses"], ref["track_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["map_losses"] / 2, ref["map_losses"],
                               rtol=1e-4)
    assert np.abs(got["est"][1:, :3, 3] - got["est"][0, :3, 3]).max() > 1e-3
