"""In-loop frame panels: ground truth, render and residual, written as
JPEG without a plotting library.

The counterpart of ``myslam_tpu.utils.visualizer.FrameVisualizer``: at
the configured frequencies the full frame is rendered from a pose
(``render.renderer.make_image_renderer``) and saved as one panel under
``{output}/tracking_vis`` or ``{output}/mapping_vis`` as
``{idx:05d}_{iter:04d}.jpg``.  The panel is a 2 x 3 grid of H x W
tiles, composed in numpy and encoded with the port's codec
(``utils/imageio.write_jpeg``); it carries no titles.  The tiles, row by
row:

    input depth | rendered depth | |depth residual|
    input RGB   | rendered RGB   | |RGB residual|

Depth tiles map [0, largest input depth] through the plasma color map;
color tiles are clipped to [0, 1].  Both residuals are 0 where the input
depth is 0.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from myslam_torch.render.renderer import make_image_renderer
from myslam_torch.utils.imageio import write_jpeg

# The plasma color map (van der Walt and Smith, CC0), 256 entries of
# uint8 RGB, each channel rounded from its float value.
PLASMA_U8 = np.frombuffer(bytes.fromhex(
    "0d088710078813078916078a19068c1b068d1d068e20068f220690240691260591280592"
    "2a05932c05942e05952f059631059733059735049837049938049a3a049a3c049b3e049c"
    "3f049c41049d43039e44039e46039f48039f4903a04b03a14c02a14e02a25002a25102a3"
    "5302a35502a45601a45801a45901a55b01a55c01a65e01a66001a66100a76300a76400a7"
    "6600a76700a86900a86a00a86c00a86e00a86f00a87100a87201a87401a87501a87701a8"
    "7801a87a02a87b02a87d03a87e03a88004a88104a78305a78405a78606a68707a68808a6"
    "8a09a58b0aa58d0ba58e0ca48f0da4910ea3920fa39410a29511a19613a19814a099159f"
    "9a169f9c179e9d189d9e199da01a9ca11b9ba21d9aa31e9aa51f99a62098a72197a82296"
    "aa2395ab2494ac2694ad2793ae2892b02991b12a90b22b8fb32c8eb42e8db52f8cb6308b"
    "b7318ab83289ba3388bb3488bc3587bd3786be3885bf3984c03a83c13b82c23c81c33d80"
    "c43e7fc5407ec6417dc7427cc8437bc9447aca457acb4679cc4778cc4977cd4a76ce4b75"
    "cf4c74d04d73d14e72d24f71d35171d45270d5536fd5546ed6556dd7566cd8576bd9586a"
    "da5a6ada5b69db5c68dc5d67dd5e66de5f65de6164df6263e06363e16462e26561e26660"
    "e3685fe4695ee56a5de56b5de66c5ce76e5be76f5ae87059e97158e97257ea7457eb7556"
    "eb7655ec7754ed7953ed7a52ee7b51ef7c51ef7e50f07f4ff0804ef1814df1834cf2844b"
    "f3854bf3874af48849f48948f58b47f58c46f68d45f68f44f79044f79143f79342f89441"
    "f89540f9973ff9983ef99a3efa9b3dfa9c3cfa9e3bfb9f3afba139fba238fca338fca537"
    "fca636fca835fca934fdab33fdac33fdae32fdaf31fdb130fdb22ffdb42ffdb52efeb72d"
    "feb82cfeba2cfebb2bfebd2afebe2afec029fdc229fdc328fdc527fdc627fdc827fdca26"
    "fdcb26fccd25fcce25fcd025fcd225fbd324fbd524fbd724fad824fada24f9dc24f9dd25"
    "f8df25f8e125f7e225f7e425f6e626f6e826f5e926f5eb27f4ed27f3ee27f3f027f2f227"
    "f1f426f1f525f0f724f0f921"), np.uint8).reshape(256, 3)


def plasma(x: np.ndarray, vmax: float) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 through PLASMA_U8 over [0, vmax],
    clamped at both ends: entry floor(256 x / vmax), the last for vmax."""
    v = np.clip(np.nan_to_num(np.asarray(x, np.float32) / np.float32(vmax)),
                0.0, 1.0)
    return PLASMA_U8[np.minimum((v * 256).astype(np.int64), 255)]


def to_u8(rgb: np.ndarray) -> np.ndarray:
    """Colors in [0, 1] (clipped) -> uint8."""
    return np.rint(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def compose_panel(gt_depth: np.ndarray, gt_color: np.ndarray,
                  depth: np.ndarray, color: np.ndarray) -> np.ndarray:
    """The 2 x 3 panel (2H, 3W, 3) uint8 of one frame: input depth,
    rendered depth, |depth residual|; input RGB, rendered RGB, |RGB
    residual|.  Residuals are 0 where the input depth is 0."""
    hole = gt_depth == 0.0
    depth_res = np.abs(gt_depth - depth)
    depth_res[hole] = 0.0
    color_res = np.abs(gt_color - color)
    color_res[hole] = 0.0
    vmax = float(np.max(gt_depth)) or 1.0
    top = [plasma(gt_depth, vmax), plasma(depth, vmax),
           plasma(depth_res, vmax)]
    bottom = [to_u8(gt_color), to_u8(color), to_u8(color_res)]
    return np.concatenate([np.concatenate(top, axis=1),
                           np.concatenate(bottom, axis=1)], axis=0)


class FrameVisualizer:
    """Renders and saves the panels of frames idx with idx % freq == 0 at
    iterations with iter % inside_freq == 0 (each frequency at least 1).

    ``draws`` is the panels' own draw source: rendering takes no number
    from the loop's, so a run's trajectory is the same with panels on or
    off.  ``records`` keeps, per saved panel, its file, frame, iteration,
    the seconds it took and the mean |rendered - input| depth over the
    pixels with depth.
    """

    def __init__(self, freq: int, inside_freq: int, vis_dir: str, scene,
                 cam, draws, verbose: bool = False):
        self.freq = max(int(freq), 1)
        self.inside_freq = max(int(inside_freq), 1)
        self.vis_dir = vis_dir
        self.draws = draws
        self.verbose = verbose
        self.records: list[dict] = []
        os.makedirs(vis_dir, exist_ok=True)
        self._render_img = make_image_renderer(scene, cam)

    def save_imgs(self, idx: int, iter_i: int, gt_depth: np.ndarray,
                  gt_color: np.ndarray, c2w: torch.Tensor,
                  ms) -> str | None:
        """Render frame idx at pose c2w (4, 4) on the map ``ms`` and save
        its panel; ``gt_depth`` (H, W) and ``gt_color`` (H, W, 3) in
        [0, 1] are the input frame on the host.  Returns the file, or
        None when the frequencies skip this (idx, iter)."""
        if idx % self.freq != 0 or iter_i % self.inside_freq != 0:
            return None
        t0 = time.perf_counter()
        depth, color = self._render_img(
            ms, c2w, torch.as_tensor(gt_depth).to(c2w.device), self.draws)
        depth = depth.cpu().numpy()
        color = color.cpu().numpy()
        out = os.path.join(self.vis_dir, f"{idx:05d}_{iter_i:04d}.jpg")
        write_jpeg(out, compose_panel(gt_depth, gt_color, depth, color))
        valid = gt_depth > 0
        self.records.append({
            "file": out, "frame": idx, "iter": iter_i,
            "seconds": time.perf_counter() - t0,
            "depth_l1_m": float(np.abs(depth - gt_depth)[valid].mean())
            if valid.any() else 0.0})
        if self.verbose:
            print(f"Saved rendering visualization at {out}")
        return out
