"""The multi-process gang: one rank is one process and one device.

``distributed`` wires the ranks into a torch.distributed process group
and counts every collective; ``distributed_ba`` holds keyframe-sharded
bundle adjustment; ``multiproc`` the launcher and the harness that runs
a small loop over the gang.
"""
