"""``bvh_reads_per_call``: the BVH tier's host read-backs (device to host
copies that end in a wait, ``nbody_tpu_torch.ops.bvh.HOST_READS``) over the
window's force calls. Nothing to read where the window made none."""


def snapshot():
    from nbody_tpu_torch.ops import bvh
    return bvh.HOST_READS["count"]


def read(run):
    start, end = run.snapshots.get("bvh_reads_per_call", (0, 0))
    if not run.force_calls or end == start:
        return None
    return (end - start) / run.force_calls
