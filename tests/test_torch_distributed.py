"""Port vs reference: ``core/distributed.py``, the ``"sharded-slots"`` and
``"distributed"`` engines, on the CPU.

The port drives several devices from one process; ``["cpu"] * D`` gives it
D > 1 blocks here, as XLA's forced host device count does for the
reference (whose in-process meshes here have the one CPU device). Inputs
are seeded numpy clouds: four lanes of the service's shapes (256 sources,
1024 targets) and frame pairs of a reduced scene (~1k target points).

  * ``stream_sharded_icp``: the port at D=1 against the reference's at
    D=1, within 1e-3; at D=2 and D=4 over repeated CPU devices the same
    bits as the port's own D=1 run of each block and as separate ``icp``
    calls (the lockstep loop), with blocks that stop at different steps.
  * The ``"sharded-slots"`` engine: at D=1 the ``"slots"`` engine's bits at
    ``slots = lanes_per_device``; at D=2 the bits of D=1 at equal lanes per
    device; ``register`` (lane 0 of the sharded batch) the batch lane's.
  * ``distributed_nn_search`` over 2 and 4 target shards (one and two
    target axes): the bits of one search of the whole target through the
    NN kernel's wrapper (its plain version here); against the plain
    chunked ``nn_search``, equal indices except on near-ties, d² within
    1e-4. The plain version scores 1024-target blocks, and every shard here
    holds whole blocks, as the NN kernel's per-pair scores need no such
    care on the card.
  * ``icp_sharded`` and ``batched_icp_sharded``, point-to-point and
    point-to-plane (the port's knn normals passed to both packages), against the
    reference's ``icp_fixed_iterations`` per frame, within 1e-4 (the
    reference's own band, ``tests/distributed_worker.py``); one target
    shard holds only far-sentinel rows.
  * ``DistributedEngine`` against the reference's ``"distributed"`` engine:
    three frames over a two-block data axis (frame padding), a warm start,
    the plane minimiser; a single pair against the ``"cuda"`` engine;
    within 1e-4.
  * The combine on the kernel's four-term score: where two shards' winners
    clamp to the same d² = 0, one search's winner all the same.
  * Error paths: ``S % D``, more cards than exist (``resolve_device`` with
    a patched count), the plane minimiser without normals.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core  # noqa: F401  (repro.core before repro.data.normals)
from repro.core import ICPParams as JICPParams
from repro.core import get_engine as jget_engine
from repro.core.distributed import stream_sharded_icp as j_stream_sharded_icp
from repro.core.distributed import streams_mesh as j_streams_mesh
from repro.core.icp import icp_fixed_iterations as j_icp_fixed
from repro.data.pointcloud import SceneConfig, frame_pair, sequence_scans
from repro_torch.core import distributed as dist
from repro_torch.core.engine import (DistributedEngine, ShardedSlotEngine,
                                     get_engine)
from repro_torch.core.icp import ICPParams, icp, params_from_reference
from repro_torch.core.nn_search import nn_search
from repro_torch.data.collate import PAD_SENTINEL, collate_pairs
from repro_torch.data.normals import default_target_normals
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import nn_search_cuda

PARITY = 1e-3
SHARDED_TOL = 1e-4
SCENE = SceneConfig(n_ground=300, n_walls=220, n_poles=60, n_clutter=70,
                    extent=12.0, sensor_range=16.0)
PAIR_SCENE = SceneConfig(n_ground=1500, n_walls=1100, n_poles=300,
                         n_clutter=300, extent=25.0, sensor_range=30.0)
LANES = 4
JPARAMS = JICPParams(max_iterations=8, max_correspondence_distance=1.0,
                     chunk=512, robust_kernel="huber", robust_scale=0.3)
PARAMS = params_from_reference(JPARAMS._asdict())
FIXED = ICPParams(max_iterations=15, chunk=256)


def _cpu_mesh(shape, names):
    return dist.Mesh(np.array(["cpu"] * int(np.prod(shape)),
                              dtype=object).reshape(shape), names)


def _lanes():
    """Four lanes at the service's shapes: frame 1 of stream s (256 rows)
    onto its frame 0 (1024 rows), masks, a warm start off by 0.2 m. Lane 1
    registers its target onto itself, so it stops first."""
    rng = np.random.default_rng(7)
    src = np.full((LANES, 256, 3), PAD_SENTINEL, np.float32)
    dst = np.full((LANES, 1024, 3), PAD_SENTINEL, np.float32)
    sv = np.zeros((LANES, 256), bool)
    dv = np.zeros((LANES, 1024), bool)
    for s in range(LANES):
        a, b = sequence_scans(s, 2, SCENE)
        a = a[rng.permutation(len(a))[:1024]]
        b = b[rng.permutation(len(b))[:256]]
        dst[s, :len(a)], dv[s, :len(a)] = a, True
        src[s, :len(b)], sv[s, :len(b)] = b, True
    src[1], sv[1] = dst[1, :256], dv[1, :256]
    T0 = np.broadcast_to(np.eye(4, dtype=np.float32), (LANES, 4, 4)).copy()
    T0[:, 0, 3] = 0.2
    T0[1] = np.eye(4)
    return src, dst, sv, dv, T0


def _bits(res, lanes=slice(None)):
    return [x[lanes].numpy().tobytes() for x in res]


# -- stream sharding ------------------------------------------------------------

@pytest.fixture(scope="module")
def lanes():
    return _lanes()


def test_stream_sharded_matches_reference_at_one_device(lanes):
    src, dst, sv, dv, T0 = lanes
    kw = dict(initial_transforms=T0, src_valid=sv, dst_valid=dv)
    jres = j_stream_sharded_icp(j_streams_mesh(1), src, dst, JPARAMS, **kw)
    tres = dist.stream_sharded_icp(dist.streams_mesh(["cpu"]), src, dst,
                                   PARAMS, **kw)
    assert np.abs(tres.T.numpy() - np.asarray(jres.T)).max() <= PARITY
    assert tres.iterations.tolist() == np.asarray(jres.iterations).tolist()
    assert tres.converged.tolist() == np.asarray(jres.converged).tolist()


@pytest.mark.parametrize("devices", [2, 4])
def test_stream_sharded_bits_do_not_depend_on_block_count(lanes, devices):
    """D blocks of L = 4 / D lanes in lockstep: each block's bits are those
    of the port's own one-block run of that block and of a separate ``icp``
    call on it; the blocks stop after different numbers of steps."""
    src, dst, sv, dv, T0 = lanes
    L = LANES // devices
    t = torch.as_tensor
    res = dist.stream_sharded_icp(
        dist.streams_mesh(["cpu"] * devices), src, dst, PARAMS,
        initial_transforms=T0, src_valid=sv, dst_valid=dv)
    assert res.T.shape == (LANES, 4, 4)
    one = dist.streams_mesh(["cpu"])
    for d in range(devices):
        blk = slice(d * L, (d + 1) * L)
        alone = dist.stream_sharded_icp(
            one, src[blk], dst[blk], PARAMS, initial_transforms=T0[blk],
            src_valid=sv[blk], dst_valid=dv[blk])
        plain = icp(t(src[blk]), t(dst[blk]), PARAMS, t(T0[blk]),
                    src_valid=t(sv[blk]), dst_valid=t(dv[blk]))
        assert _bits(res, blk) == _bits(alone) == _bits(plain)
    assert len(set(res.iterations.tolist())) > 1


@pytest.mark.parametrize("devices", [1, 2])
def test_sharded_slot_engine_block_bits(lanes, devices):
    """``"sharded-slots"`` (the slot engine's per-block program, the NN
    kernel's plain version here): at D blocks of L=2 lanes, each block's
    bits are the ``"slots"`` engine's at ``slots=2`` on that block; a lone
    pair through ``register`` gives its batch lane's bits."""
    src, dst, sv, dv, T0 = lanes
    L = 2
    eng = get_engine("sharded-slots", device="cpu", lanes_per_device=L,
                     devices=devices)
    assert isinstance(eng, ShardedSlotEngine) and eng.slots == devices * L
    slots = get_engine("slots", device="cpu", slots=L)
    n = devices * L
    kw = dict(initial_transforms=T0[:n], src_valid=sv[:n], dst_valid=dv[:n])
    res = eng.register_batch(src[:n], dst[:n], PARAMS, **kw)
    for d in range(devices):
        blk = slice(d * L, (d + 1) * L)
        ref = slots.register_batch(src[blk], dst[blk], PARAMS,
                                   initial_transforms=T0[blk],
                                   src_valid=sv[blk], dst_valid=dv[blk])
        assert _bits(res, blk) == _bits(ref)
    one = eng.register(src[0], dst[0], PARAMS, T0[0], src_valid=sv[0],
                       dst_valid=dv[0])
    assert [x.numpy().tobytes() for x in one] == _bits(res, 0)


def test_register_blocks_takes_placed_blocks(lanes):
    src, dst, sv, dv, T0 = lanes
    eng = ShardedSlotEngine(lanes_per_device=2, devices=["cpu", "cpu"])
    place = eng.place
    blocks = eng.register_blocks(
        place(src), place(dst), PARAMS, initial_transforms=place(T0),
        src_valid=place(sv), dst_valid=place(dv))
    whole = eng.register_batch(src, dst, PARAMS, initial_transforms=T0,
                               src_valid=sv, dst_valid=dv)
    assert len(blocks) == 2
    assert _bits(dist.gather_lanes(blocks, "cpu")) == _bits(whole)


# -- the legacy point-sharded family -----------------------------------------------

@pytest.mark.parametrize("axes,shape", [(("model",), (2,)),
                                        (("model",), (4,)),
                                        (("data", "model"), (2, 2))],
                         ids=["2", "4", "2x2"])
def test_distributed_nn_search_matches_one_search(axes, shape):
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.uniform(-20, 20, (256, 3)).astype(np.float32))
    dst = torch.as_tensor(rng.uniform(-20, 20, (4096, 3)).astype(np.float32))
    dst[100] = dst[3000]  # an exact cross-shard tie: the first index wins
    src[0] = dst[3000]
    d2, idx = dist.distributed_nn_search(_cpu_mesh(shape, axes), src, dst,
                                         target_axes=axes)
    d2_1, idx_1 = nn_search_cuda(src, dst)
    assert torch.equal(d2, d2_1) and torch.equal(idx, idx_1)
    assert int(idx[0]) == 100
    d2_p, idx_p = nn_search(src, dst, chunk=512)
    off = idx != idx_p
    assert torch.allclose(d2, d2_p, atol=SHARDED_TOL, rtol=SHARDED_TOL)
    assert torch.all((d2[off] - d2_p[off]).abs() <= SHARDED_TOL)


def test_distributed_nn_search_keeps_the_kernels_tie_order():
    """Each source point has two targets within a few micrometres, one in
    each shard, whose finished d² clamp to the same 0 while the kernel's
    four-term scores differ: one search takes the lower score (often the
    second shard's copy). The combine compares those scores too, so it
    gives one search's indices here, where comparing the finished d²
    would take the first shard's copy on ~9% of the queries."""
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.uniform(-30, 30, (1024, 3)).astype(np.float32))
    dst = torch.cat([pts + 3e-6, pts])
    d2, idx = dist.distributed_nn_search(_cpu_mesh((2,), ("model",)), pts,
                                         dst)
    d2_1, idx_1 = nn_search_cuda(pts, dst)
    assert torch.equal(d2, d2_1) and torch.equal(idx, idx_1)
    assert int((idx_1 >= 1024).sum()) > 0


def _pair(frame):
    src, dst, T_gt = frame_pair(0, frame, PAIR_SCENE, n_source_samples=512)
    return src, dst, T_gt


def _padded_target(dst, rows=2048):
    """The target padded to ``rows`` with far-sentinel rows: with four
    shards the last holds sentinel rows only."""
    out = np.full((rows, 3), PAD_SENTINEL, np.float32)
    out[:len(dst)] = dst
    return out


def _normals(dst, valid=None):
    """Target normals (the port's knn estimate), given to both packages."""
    return default_target_normals(
        torch.as_tensor(dst), None if valid is None
        else torch.as_tensor(valid)).numpy()


@functools.cache
def _j_icp_fixed(params: JICPParams):
    """The reference's ``icp_fixed_iterations``, compiled once per params."""
    return jax.jit(lambda s, d, sv, n: j_icp_fixed(
        s, d, params, src_valid=sv, target_normals=n))


@pytest.mark.parametrize("minimizer", ["point_to_point", "point_to_plane"])
def test_icp_sharded_matches_reference(minimizer):
    src, dst, T_gt = _pair(2)
    assert len(dst) <= 1536  # shard 3 of 4 holds sentinel rows only
    params = FIXED._replace(minimizer=minimizer)
    jparams = JICPParams(**params._asdict())
    plane = minimizer == "point_to_plane"
    nrm = _normals(dst) if plane else None
    ref = _j_icp_fixed(jparams)(src, dst, None, nrm)
    padded = _padded_target(dst)
    nrm_pad = None
    if plane:
        nrm_pad = np.zeros_like(padded)
        nrm_pad[:len(dst)] = nrm
    res = dist.icp_sharded(_cpu_mesh((2, 2), ("data", "model")), src, padded,
                           params, target_axes=("data", "model"),
                           fixed_iterations=True, dst_normals=nrm_pad)
    assert np.abs(res.T.numpy() - np.asarray(ref.T)).max() <= SHARDED_TOL
    assert np.abs(res.T.numpy() - T_gt).max() <= 0.05
    assert int(res.iterations) == int(np.asarray(ref.iterations))


@pytest.mark.parametrize("minimizer", ["point_to_point", "point_to_plane"])
def test_batched_icp_sharded_matches_reference(minimizer):
    """Four collated frames (sentinel-padded targets, source masks) over a
    2 x 2 mesh; the reference runs each padded frame alone, with the same
    normals (estimated on the padded targets with their true masks)."""
    batch = collate_pairs([_pair(f)[:2] for f in range(4)])
    params = FIXED._replace(minimizer=minimizer)
    jparams = JICPParams(**params._asdict())
    dst = np.where(batch.dst_valid[..., None], batch.dst, PAD_SENTINEL)
    nrm = None
    if minimizer == "point_to_plane":
        nrm = _normals(batch.dst, batch.dst_valid)
    mesh = _cpu_mesh((2, 2), ("data", "model"))
    res = dist.batched_icp_sharded(mesh, batch.src, dst, params,
                                   src_valid=batch.src_valid,
                                   dst_normals=nrm)
    placed = dist.shard_inputs(mesh, batch.src, dst)
    again = dist.batched_icp_sharded(mesh, *placed, params,
                                     src_valid=batch.src_valid,
                                     dst_normals=nrm)
    assert _bits(again) == _bits(res)
    for f in range(4):
        ref = _j_icp_fixed(jparams)(batch.src[f], dst[f], batch.src_valid[f],
                                    None if nrm is None else nrm[f])
        assert np.abs(res.T[f].numpy() - np.asarray(ref.T)).max() \
            <= SHARDED_TOL, f


def test_distributed_engine_matches_reference():
    """Three frames over a two-block data axis (padded by repeating frame
    0), a warm start off the identity, the plane minimiser (the engine
    estimates the normals on the unsharded targets); a single pair (a
    batch of one) against the ``"cuda"`` engine's. The point-to-point
    engine is held to the reference's by ``tests/test_torch_launch.py``."""
    pairs = [_pair(f)[:2] for f in range(3)]
    params = FIXED._replace(minimizer="point_to_plane")
    jparams = JICPParams(**params._asdict())
    T0 = np.broadcast_to(np.eye(4, dtype=np.float32), (3, 4, 4)).copy()
    T0[:, 0, 3] = [0.1, -0.05, 0.2]
    jres, _ = jget_engine("distributed").register_pairs(
        pairs, jparams, initial_transforms=T0)
    eng = get_engine("distributed", device="cpu",
                     mesh=_cpu_mesh((2, 1), ("data", "model")))
    assert isinstance(eng, DistributedEngine)
    assert eng is not get_engine("distributed", device="cpu",
                                 mesh=eng.mesh)  # a mesh: private engines
    res, _ = eng.register_pairs(pairs, params, initial_transforms=T0)
    assert res.T.shape == (3, 4, 4)
    assert np.abs(res.T.numpy() - np.asarray(jres.T)).max() <= SHARDED_TOL
    src, dst = pairs[1]
    one = eng.register(src, dst, params, T0[1])
    ref = get_engine("cuda", device="cpu").register(src, dst, params, T0[1])
    assert np.abs(one.T.numpy() - ref.T.numpy()).max() <= SHARDED_TOL


# -- error paths --------------------------------------------------------------------

def test_lane_count_must_divide_the_mesh(lanes):
    src, dst, sv, dv, T0 = lanes
    with pytest.raises(ValueError, match="must divide"):
        dist.stream_sharded_icp(dist.streams_mesh(["cpu"] * 3), src, dst,
                                PARAMS)
    with pytest.raises(ValueError, match="must divide"):
        dist.batched_icp_sharded(_cpu_mesh((3, 1), ("data", "model")),
                                 src[:2], dst[:2], FIXED)


def test_more_cards_than_exist_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="has 2 CUDA"):
        resolve_device("cuda:3")
    with pytest.raises(ValueError, match="has 2 CUDA"):
        dist.streams_mesh(3)
    with pytest.raises(ValueError, match="has 2 CUDA"):
        dist.streams_mesh(["cuda:0", "cuda:2"])
    with pytest.raises(ValueError, match=">= 1"):
        dist.streams_mesh(0)
    mesh = dist.streams_mesh(2)
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1"]
    assert resolve_device("cuda:1") == torch.device("cuda", 1)


def test_plane_minimizer_needs_normals():
    plane = FIXED._replace(minimizer="point_to_plane")
    src, dst, _ = _pair(0)
    mesh = _cpu_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="dst_normals"):
        dist.icp_sharded(mesh, src, _padded_target(dst), plane)
    with pytest.raises(ValueError, match="dst_normals"):
        dist.batched_icp_sharded(mesh, src[None], _padded_target(dst)[None],
                                 plane)
    with pytest.raises(ValueError, match="not in the mesh"):
        dist.distributed_nn_search(mesh, src, dst, target_axes=("streams",))
