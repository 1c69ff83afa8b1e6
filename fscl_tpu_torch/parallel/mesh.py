"""A run's place in a split over processes (the counterpart of
fscl_tpu/parallel/mesh.py:make_scan_mesh).

The JAX package shards its work over a (perm, site) device mesh, one
process a host under jax.distributed.  Here the idiom is PyTorch's: one
process a device, started by ``python -m torch.distributed.run``, each
process a rank of one ``torch.distributed`` group.  The mesh's two axes
collapse to one: every production consumer in fscl_tpu shards over the
product ("perm", "site") anyway (fscl_tpu/parallel/mesh.py:34-41), the
scan's candidates and the permutations' replicates alike, so a rank
takes a contiguous share of whichever axis the stage splits
(parallel/shard.py:split_range).

The group is gloo over host tensors: every exchange is of arrays the
drivers already read back to the host (parallel/shard.py), so the same
code runs on the CPU and with two ranks on one card, where NCCL refuses
two ranks on one GPU.

Device of a rank: ``cuda`` maps rank r to ``cuda:LOCAL_RANK`` and raises
where the host has no such card; ``cuda:N`` pins every rank to card N
(two ranks sharing one H100); ``cpu`` is the CPU.  No rank falls back to
another device.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..device import parse_device


@dataclasses.dataclass(frozen=True)
class Split:
    """This process's place in the split: ``rank`` of ``world``, its gloo
    ``group`` (None in a world of one) and its ``device``."""

    rank: int = 0
    world: int = 1
    group: object = None
    device: torch.device = torch.device("cpu")

    @property
    def writer(self) -> bool:
        """Whether this rank writes the run's files and status lines."""
        return self.rank == 0


def rank_device(device, local_rank):
    """The device of the rank with this LOCAL_RANK (see the module doc)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0 and local_rank == 0:
            return parse_device(dev)  # its own error: no card at all
        if local_rank >= n:
            raise RuntimeError(
                f"--device cuda maps local rank {local_rank} to "
                f"cuda:{local_rank}, but this host has {n} CUDA "
                "device(s); start fewer ranks a host, or pin every rank "
                "to one card with --device cuda:N"
            )
        dev = torch.device("cuda", local_rank)
    return parse_device(dev)


def _env_int(name, default):
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def init_split(device="cuda") -> Split:
    """This process's Split, from torch.distributed.run's RANK,
    WORLD_SIZE and LOCAL_RANK; without them the world is one process and
    nothing is initialised.  A world of more than one joins the default
    process group, starting it on gloo at ``env://`` (MASTER_ADDR and
    MASTER_PORT, as torch.distributed.run sets them) unless the caller
    started one."""
    world, rank = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
    dev = rank_device(device, _env_int("LOCAL_RANK", rank))
    if world <= 1:
        return Split(device=dev)
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world)
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError(
            f"process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, not {rank} of {world}")
    group = (dist.group.WORLD if dist.get_backend() == "gloo"
             else dist.new_group(backend="gloo"))
    return Split(rank=rank, world=world, group=group, device=dev)


def close_split(split) -> None:
    """Leave the process group init_split joined (nothing in a world of
    one)."""
    if split is not None and split.world > 1:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


SOLO = Split()  # the world of one: every rank's share is the whole axis
