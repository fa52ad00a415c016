"""Coarse SDF points per pass of the importance branch: the program's
``render.renderer.IMPORTANCE_COUNTS`` (host integers from the tensors'
shapes, kept for the whole process) read after the run, ``points`` over
``passes``.  Under stationary traffic every pass has the same shape (a
mapping iteration's rays times ``n_stratified``), so the whole run's
ratio is the window's.  None where the program keeps no such counter or
took no pass."""


def read(run):
    from myslam_torch.render import renderer

    counts = getattr(renderer, "IMPORTANCE_COUNTS", None)
    if not counts or not counts.get("passes"):
        return None
    return counts["points"] / counts["passes"]
