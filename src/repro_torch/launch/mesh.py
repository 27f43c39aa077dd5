"""Production and debug meshes (the reference's ``launch/mesh.py``).

FUNCTIONS, not module constants, so importing never touches the device
or the process group.  A ``DeviceMesh`` needs a process group with one
rank a mesh position: ``torch.distributed.init_process_group`` with an
address, a world size and a rank (``tcp://localhost:<port>`` on one
machine), or, for the dry run, the fake group of 512 ranks that
``launch/dryrun.py`` starts (``start_fake_group``), in which only rank 0
runs and every collective returns at once.
"""
from __future__ import annotations


def start_fake_group(world_size: int = 512) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (the dry run's stand-in for XLA's forced host device count).  A no-op
    when a group exists already."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(device_type: str, shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for a {'x'.join(map(str, shape))} mesh, the "
            f"process group has {have}: start one with "
            f"torch.distributed.init_process_group, or for the dry run "
            f"repro_torch.launch.mesh.start_fake_group({max(n, 512)})")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; the ``pod`` axis is either extra
    batch parallelism (train/serve) or the prefill/decode disaggregation
    axis (core/disagg.py).  The logical shapes are the reference's;
    raises when the process group has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) mesh over the first data * model ranks of the
    process group (tests)."""
    return _mesh(device_type, (data, model), ("data", "model"))
