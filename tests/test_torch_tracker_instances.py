"""The rule that picks the tracker walk kernel's instance
(ops/device_tracker.TrackerWalk.instance): the shared-memory instance
where the pools' bulky arrays fit a block beside the staged lattice chunk
and the assembly's scratch, else the global-memory one.  The footprint
itself is held to the kernel source's layout by
tests/test_torch_tracker_kernel_source.py."""

import inspect

import pytest
import torch

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
from gr_lora_tpu_torch.models.device_tracker import make_device_tracker
from gr_lora_tpu_torch.ops import device_tracker as ops

CFG = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                 payload_len=8, p=2, fft_factor=8, threshold=5.0)


def _default_peaks(cls) -> int:
    return inspect.signature(cls).parameters["max_peaks"].default


@pytest.mark.parametrize("split", [False, True], ids=["plain", "split"])
@pytest.mark.parametrize("gateway", [TriggeredPyramidGateway,
                                     PyramidGateway],
                         ids=["gated", "always_on"])
def test_gateway_default_pools_take_shared(gateway, split):
    """The gateways' default pools (their max_peaks, the tracker's
    default pools), with and without split_repeats, fit a block: 66 560
    or 107 520 bytes of bulk arrays beside the chunk and the scratch."""
    walk = make_device_tracker(CFG, _default_peaks(gateway),
                               split_repeats=split)
    assert walk.instance() == "shared"
    bulk = walk.shared_bytes() - walk.shared_bytes(instance="global")
    assert bulk == (107520 if split else 66560)
    assert walk.shared_bytes() <= ops.MAX_SHARED


def test_track_256_split_takes_global():
    """Track pool 256 with split_repeats: rings 229 376 B, t_mid_h
    16 384 B, packet entries 46 080 B, past a block's 232 448 B: the
    global instance, whose own footprint is the chunk and the scratch."""
    walk = make_device_tracker(CFG, 8, track_pool=256, split_repeats=True)
    bulk = walk.shared_bytes() - walk.shared_bytes(instance="global")
    assert bulk == 229376 + 16384 + 46080
    assert walk.instance() == "global"
    assert walk.shared_bytes(instance="global") < 48 * 1024
    # Without split_repeats the same pool fits (rings of 16).
    assert make_device_tracker(CFG, 8, track_pool=256).instance() == "shared"


def test_instance_follows_the_lattice_width():
    """The chunk grows with the lattice's peaks a hop (rows of m | 1):
    the rule reads the width it is given, the walk's max_peaks by
    default."""
    walk = make_device_tracker(CFG, 8, track_pool=256, packet_pool=64,
                               split_repeats=True, max_symbols=56)
    widths = {m: walk.shared_bytes(m) for m in (1, 8, 9, 64)}
    assert widths[8] == walk.shared_bytes()
    assert widths[8] == widths[9]          # both staged in rows of 9
    assert widths[1] < widths[8] < widths[64]
    assert all(walk.instance(m) == ("shared" if b <= ops.MAX_SHARED
                                    else "global")
               for m, b in widths.items())


@pytest.mark.parametrize("kwargs", [
    dict(track_pool=512), dict(packet_pool=0), dict(packet_pool=300),
    dict(finalize_per_hop=33), dict(expire_per_hop=41),
    dict(out_pool=0)], ids=["track", "packet0", "packet", "finalize",
                            "expire", "out"])
def test_check_still_raises_on_pools(kwargs):
    """check() refuses the pools it refused before the instances
    (at most 256 slots a pool, 32 retirements a hop, expire_per_hop <=
    packet_pool, an output slot), whatever the footprint."""
    walk = ops.TrackerWalk(CFG, 8, **kwargs)
    z = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="pools of at most"):
        walk.check(walk.init_state(2, "cpu"), z, z.float(), z.float(),
                   z.bool())


def test_check_still_raises_on_the_lattice():
    """check() refuses a lattice wider than 64 peaks and, for the card's
    kernel, tensors that are not CUDA tensors of the kernel's types."""
    walk = ops.TrackerWalk(CFG, 8)
    st = walk.init_state(2, "cpu")
    wide = torch.zeros((2, 4, 65), dtype=torch.int32)
    with pytest.raises(ValueError, match="lattice must be"):
        walk.check(st, wide, wide.float(), wide.float(), wide.bool())
    z = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        walk.check(st, z, z.float(), z.float(), z.bool())


def test_cpu_process_counts_no_launch():
    """On CPU tensors process runs the plain walk: neither instance's
    launch count moves."""
    walk = ops.TrackerWalk(CFG, 8, track_pool=256, split_repeats=True)
    st = walk.init_state(1, "cpu")
    z = torch.zeros((1, 3, 8), dtype=torch.int32)
    before = (ops.launches, ops.global_launches)
    walk.process(st, z, z.float(), z.float(), z.bool())
    assert (ops.launches, ops.global_launches) == before
    assert int(st["ts_ref"][0]) == 3 * walk.hop
