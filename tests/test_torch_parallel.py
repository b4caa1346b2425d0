"""The port's data parallelism and sequence-parallel ring scan against the
JAX package, on the CPU.

The port's ranks are spawned processes joined in a gloo group
(``parallel/dryrun.py`` ``start``; their tasks are in
``tests/torch_workers.py``, which imports torch and the port only). Two
groups are started once for the module, and run while the JAX side
compiles: 2 ranks for the data-parallel cases and 4 for the ring scan. Each
join has its own 120 s timeout, so a hung group fails instead of eating the
suite's limit.

Data parallelism uses tests/test_dp_equivalence.py's setup: gm_test at
32x32, a batch of 8, SGD with momentum 0.9, 3 steps; with on-device
augmentation, 64x64 raw slices zoomed to 32. Against one process (no
group) the ranks are held at the JAX dry run's ``assert_equiv`` tolerance
(``dryrun.assert_equiv``: rtol 1e-5, atol 1e-8 + 1e-5 * max), with the
decoder's stochastic depth on. Against JAX's ``make_train_step`` on
``make_mesh(2)`` (the same weights, bridged by the JAX package's
converter) stochastic depth is off (EMCAD patched on the JAX side, as in
tests/test_torch_train.py), the port's augmentation takes JAX's own draws
(``torch_workers.injected_draws``), and the JAX augmented step is its plain
step on ``device_augment`` of the batch with the key it splits off (what
the JAX step computes: tests/test_device_aug.py), at
tests/test_torch_train.py's tolerances: per-step losses within 2e-4 * (1 +
step), each parameter's move within the fp32 gradient tolerance (rtol 2e-3,
atol 1e-8 + 2e-3 * max|move|), BatchNorm statistics rtol 1e-5, atol 1e-6.

The ring scan on 4 ranks is held against JAX's ``shard_map`` over 4 of the
8 virtual devices at tests/test_ring_scan.py's and tests/test_sp_ss2d.py's
tolerances.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_workers
from ceigm_unet_tpu.convert.torch_import import convert_msvm_unet_state_dict
from ceigm_unet_tpu.data import device_aug as jdevice_aug
from ceigm_unet_tpu.models import emcad as jemcad
from ceigm_unet_tpu.models import msvm_unet as jmsvm
from ceigm_unet_tpu.ops.selective_scan import selective_scan as jselscan
from ceigm_unet_tpu.parallel import make_mesh, shard_batch
from ceigm_unet_tpu.parallel import ring_scan as jring
from ceigm_unet_tpu.train.trainstep import TrainState, make_train_step
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.parallel import (dryrun, init_data_parallel, mesh,
                                           ring_scan, shard_batch as tshard)
from ceigm_unet_tpu_torch.train import loop
from ceigm_unet_tpu_torch.train.config import ACDC_CONFIG

torch.set_num_threads(1)

GM_TEST_DEPTHS = (1, 1, 1, 1)
N_STEPS = 3
JOIN_S = 120.0


def _batch(aug: bool):
    rng = np.random.default_rng(42)
    if aug:
        image = rng.uniform(0, 1, (8, 64, 64, 1))
        label = rng.integers(0, 4, (8, 64, 64))
    else:
        image = rng.standard_normal((8, 32, 32, 1))
        label = rng.integers(0, 4, (8, 32, 32))
    return image.astype(np.float32), label.astype(np.int64)


CASES = {"plain": (*_batch(False), [False] * N_STEPS, False),
         "frozen": (*_batch(False), [True, False, False], False),
         "device_aug": (*_batch(True), [False] * N_STEPS, True)}


def _step_keys():
    key, out = jax.random.PRNGKey(7), []
    for _ in range(N_STEPS):
        key, k = jax.random.split(key)
        out.append(k)
    return out


def _jax_draws(key, B, H, W, out):
    """The draws JAX's device_augment makes from ``key`` (its own key
    splits), as numpy arrays of the port's parameter dict
    (tests/test_torch_data.py's replay)."""
    rows = []
    for k in jax.random.split(key, B):
        ka, kp, kw, _, _, kc, ke = jax.random.split(k, 7)
        active = jdevice_aug.someof_active(ka)
        fu, fl, sc, rot, sh, tr = jdevice_aug._affine_params(kp, active)
        ks, kj = jax.random.split(kw)
        pscale = jax.random.uniform(ks, (), minval=0.008, maxval=0.03)
        jit = jax.random.normal(kj, (16, 2)) * pscale * jnp.array(
            [H, W], jnp.float32)
        rows.append(dict(
            active=active, flipud=fu, fliplr=fl, scale=sc, rot=rot,
            shear=sh, trans=tr, jitter=jnp.where(active[8], jit, 0.0),
            alpha=jax.random.uniform(kc, (), minval=0.5, maxval=1.5),
            noise=jax.random.normal(ke, (out, out))))
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}


def _aug_keys():
    """Per step, the key the JAX step splits off for its augmentation."""
    return [jax.random.split(k)[0] for k in _step_keys()]


def _acdc_dir(root):
    """ACDC-format slices (8, 2 steps per epoch at batch 4) and one test
    volume, with their lists (tests/test_torch_loop.py's layout)."""
    data, lists = root / "ACDC", root / "lists"
    for d in (data / "train", data / "test", lists):
        d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(8):
        names.append(f"case_{i:03d}_sliceED_0.npz")
        np.savez(data / "train" / names[-1],
                 img=rng.random((48, 48)).astype(np.float32),
                 label=rng.integers(0, 4, (48, 48)).astype(np.float32))
    (lists / "train.txt").write_text("\n".join(names))
    np.savez(data / "test" / "case_t.npz",
             img=rng.random((3, 48, 48)).astype(np.float32),
             label=rng.integers(0, 4, (3, 48, 48)).astype(np.float32))
    (lists / "test.txt").write_text("case_t.npz")
    return str(data), str(lists)


def _ring_inputs():
    """tests/test_ring_scan.py's inputs."""
    r0, r2, r1, r5 = (np.random.default_rng(s) for s in (0, 2, 1, 5))
    f32 = lambda a: np.asarray(a, np.float32)
    scan = dict(a=f32(np.exp(-0.3 * r0.random((4, 6, 1, 512)))),
                b=f32(r0.standard_normal((4, 6, 1, 512))))
    grad = dict(a=f32(np.exp(-0.3 * r2.random((2, 3, 256)))),
                b=f32(r2.standard_normal((2, 3, 256))),
                ct=f32(r2.standard_normal((2, 3, 256))))

    def sp_inputs(rng, batch, dim, L, with_d):
        d = dict(u=f32(rng.standard_normal((batch, dim, L))),
                 delta=f32(0.4 * rng.standard_normal((batch, dim, L))),
                 A=f32(-0.5 - rng.random((dim, 1))),
                 B=f32(rng.standard_normal((batch, 1, 1, L))),
                 C=f32(rng.standard_normal((batch, 1, 1, L))))
        if with_d:
            d.update(D=f32(rng.standard_normal(dim)),
                     bias=f32(0.1 * rng.standard_normal(dim)))
        return d
    return (scan, grad, sp_inputs(r1, 2, 8, 256, True),
            sp_inputs(r5, 2, 4, 128, False))


RING = _ring_inputs()
_r = np.random.default_rng(6)
LOSS_ARGS = (_r.standard_normal((8, 12, 10, 9)).astype(np.float32),
             _r.integers(0, 9, (8, 12, 10)).astype(np.int64),
             _r.random(9).astype(np.float32) + 0.5)
INFER_IMAGE = np.random.default_rng(0).standard_normal(
    (8, 32, 32, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def loop_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    data, lists = _acdc_dir(root)
    cfg = dataclasses.replace(
        ACDC_CONFIG, data_dir=data, list_dir=lists, enc_name="gm_test",
        img_size=32, batch_size=4, num_workers=0, val_every_early=1,
        log_dir=str(root / "logs"), ckpt_dir=str(root / "ckpt"))
    return cfg, root


@pytest.fixture(scope="module")
def launched(loop_cfg):
    """The two groups, started once; their ranks run while the JAX side
    compiles."""
    cfg, _ = loop_cfg
    draws = [_jax_draws(k, 8, 64, 64, 32) for k in _aug_keys()]
    groups = dict(
        dp=dryrun.start(2, torch_workers.dp_cases,
                        (CASES, draws, INFER_IMAGE, LOSS_ARGS,
                         (cfg, cfg.data_dir, cfg.list_dir))),
        ring=dryrun.start(4, torch_workers.ring_cases, RING))
    yield groups
    for g in groups.values():       # a group a failed test left running
        if any(p.is_alive() for p in g.procs):
            with pytest.raises(Exception):
                g.join(0.0)


@pytest.fixture(scope="module")
def dp(launched):
    return launched["dp"].join(JOIN_S)


@pytest.fixture(scope="module")
def ring(launched):
    return launched["ring"].join(JOIN_S)


# --- data parallelism: 2 ranks against JAX's make_mesh(2) --------------------

@pytest.fixture(scope="module")
def jax_dp(launched):
    """JAX's 3-step SGD trajectories on make_mesh(2) for each case, from
    the port's seeded gm_test weights, drop-path off: (losses, params,
    batch_stats, initial variables)."""
    model = build_model(num_classes=4, enc_name="gm_test", device="cpu")
    v = convert_msvm_unet_state_dict(
        {k: t.numpy() for k, t in model.state_dict().items()},
        depths=GM_TEST_DEPTHS)
    mesh2 = make_mesh(2)
    repl = NamedSharding(mesh2, P())
    tx = optax.sgd(1e-2, momentum=0.9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmsvm, "EMCAD", functools.partial(jemcad.EMCAD,
                                                     drop_path_rate=0.0))
        jm = jmsvm.build_model(num_classes=4, enc_name="gm_test",
                               scan_backend="assoc")
        step = jax.jit(make_train_step(jm, 0.4, 0.6),
                       out_shardings=(repl, repl))
        augment = jax.jit(functools.partial(jdevice_aug.device_augment,
                                            out_size=32))
        out = {}
        for case, (image, label, frozen, aug) in CASES.items():
            state = jax.device_put(TrainState(
                step=jnp.zeros((), jnp.int32), params=v["params"],
                batch_stats=v["batch_stats"],
                opt_state=tx.init(v["params"]), tx=tx), repl)
            losses = []
            for i, k in enumerate(_step_keys()):
                img, lab = jnp.asarray(image), jnp.asarray(label, jnp.int32)
                if aug:
                    img, lab = augment(jax.random.split(k)[0], img[..., 0],
                                       lab)
                    img = ((img - 0.5) / 0.5)[..., None]
                state, m = step(state, shard_batch(
                    mesh2, {"image": img, "label": lab}), k,
                    jnp.asarray(frozen[i]))
                losses.append(float(m["loss"]))
            out[case] = (losses, jax.tree_util.tree_map(
                np.asarray, {"params": state.params,
                             "batch_stats": state.batch_stats}))
    return out, jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_jax_make_mesh_2(jax_dp, dp, case):
    out, v0 = jax_dp
    want_losses, want = out[case]
    losses, state = dp[0]["trajectories"][case, "no drop-path"]
    for i, (got, w) in enumerate(zip(losses, want_losses)):
        assert abs(got - w) <= 2e-4 * (1 + i) * max(1.0, abs(w)), (i, got, w)
    sd = jax_import.state_dict_from_jax(want, depths=GM_TEST_DEPTHS)
    sd0 = jax_import.state_dict_from_jax(v0, depths=GM_TEST_DEPTHS)
    names = [n for n, _ in build_model(num_classes=4, enc_name="gm_test",
                                       device="cpu").named_parameters()]
    moved = 0
    for name in names:
        got, w = state[name] - sd0[name], sd[name] - sd0[name]
        np.testing.assert_allclose(
            got, w, rtol=2e-3, atol=1e-8 + 2e-3 * np.abs(w).max(),
            err_msg=name)
        moved += bool(np.abs(w).max() > 0)
    assert moved > len(names) // 2
    stats = [k for k in state if "running" in k]
    assert len(stats) == 2 * 12
    for name in stats:
        np.testing.assert_allclose(state[name], sd[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# --- data parallelism: 2 ranks against one process ---------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_process(dp, case):
    image, label, frozen, aug = CASES[case]
    one = dryrun.trajectory(image, label, frozen,
                            device_aug_size=32 if aug else None)
    for rank in (0, 1):
        dryrun.assert_equiv(one, dp[rank]["trajectories"][case])
    # every rank holds the same model after the averaged steps
    for k, a in dp[0]["trajectories"][case][1].items():
        np.testing.assert_array_equal(a, dp[1]["trajectories"][case][1][k],
                                      err_msg=k)


# --- losses, inference and the training loop ---------------------------------

def test_losses_on_two_ranks_are_the_global_batch_losses(dp):
    """Each rank returns the global batch's loss, and the backward of its
    rows' logits is 2 (the world size) times their share of the global
    gradient: the convention the step's gradient average undoes
    (``parallel/mesh.py``)."""
    one = torch_workers.losses(*LOSS_ARGS)
    for name, (loss, grad) in one.items():
        for r in (0, 1):
            got_loss, got_grad = dp[r]["losses"][name]
            assert abs(got_loss - loss) <= 1e-6 * abs(loss), (name, r)
            np.testing.assert_allclose(
                got_grad, 2 * grad[4 * r:4 * (r + 1)], rtol=1e-5,
                atol=1e-7 * np.abs(grad).max(), err_msg=name)


def test_dp_inference_has_zero_collectives_and_one_process_logits(dp):
    model = build_model(num_classes=4, enc_name="gm_test", device="cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(INFER_IMAGE)).numpy()
    got = np.concatenate([dp[r]["inference"][0] for r in (0, 1)])
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max() + 1e-6)
    for r in (0, 1):
        assert dp[r]["inference"][1] == {}


def _rows(log_dir, name):
    with open(os.path.join(log_dir, f"{name}.metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_run_training_on_two_ranks_equals_one_process(dp, loop_cfg,
                                                      monkeypatch):
    """2 steps of run_training: rank 0's history rows equal one process's
    (but for the timings), rank 0 alone writes, and both stop together."""
    cfg, root = loop_cfg
    import ceigm_unet_tpu_torch.data.datasets as datasets
    one = dataclasses.replace(cfg, log_dir=str(root / "one" / "logs"),
                              ckpt_dir=str(root / "one" / "ckpt"))
    ds = datasets.ACDCDataset(cfg.data_dir, "train", cfg.list_dir,
                              cfg.img_size, seed=cfg.seed)
    val = datasets.ACDCDataset(cfg.data_dir, split="test",
                               list_dir=cfg.list_dir, augment=False)
    _, step = loop.run_training(one, ds, [val[i] for i in range(len(val))],
                                max_steps=2, device="cpu")
    assert [dp[r]["loop"] for r in (0, 1)] == [step.count] * 2 == [2, 2]
    want = _rows(one.log_dir, one.name)
    got = _rows(os.path.join(cfg.log_dir, "rank0"), cfg.name)
    timing = ("epoch_time_s", "slices_per_s")
    assert [{k: v for k, v in r.items() if k not in timing} | {
        "mean_train_loss": 0} for r in got] == [
        {k: v for k, v in r.items() if k not in timing} | {
            "mean_train_loss": 0} for r in want]
    for g, w in zip(got, want):
        assert abs(g["mean_train_loss"] - w["mean_train_loss"]) <= 1e-5 * \
            abs(w["mean_train_loss"])
    assert sorted(os.listdir(os.path.join(cfg.ckpt_dir, "rank0"))) == \
        sorted(os.listdir(one.ckpt_dir)) == ["acdc-best.ckpt",
                                             "acdc-last.ckpt"]
    for d in (cfg.log_dir, cfg.ckpt_dir):
        assert not os.path.exists(os.path.join(d, "rank1"))


# --- the process-group helpers -----------------------------------------------

def test_a_group_of_one_refuses_another_size_and_runs_the_sp_check(
        tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        init_data_parallel(1, device="cuda", store_path=str(tmp_path / "s"))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_data_parallel(None, device="cpu")
    with pytest.raises(ValueError, match="needs its size"):
        init_data_parallel(None, device="cpu", store_path=str(tmp_path / "u"))
    assert mesh.active_group() is None
    with pytest.raises(RuntimeError, match="no process group"):
        ring_scan.sequence_parallel_scan(torch.ones(3), torch.ones(3))
    try:
        init_data_parallel(1, device="cpu", store_path=str(tmp_path / "t"))
        with pytest.raises(ValueError, match="fake 2-way"):
            init_data_parallel(2, device="cpu")
        batch = {"x": torch.arange(6)}
        assert torch.equal(tshard(batch)["x"], batch["x"])
        assert mesh.global_rows(3) == (3, 0)
        with mesh.watch_collectives() as calls:
            ring_scan.selective_scan_sp_check("cpu")
        assert calls.get("all_gather")
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.active_group() is None


def test_shard_batch_rows_and_the_loader_shard(monkeypatch):
    monkeypatch.setattr(mesh, "rank_and_size", lambda: (1, 4))
    got = tshard({"x": torch.arange(8), "y": torch.arange(16).view(8, 2)})
    assert got["x"].tolist() == [2, 3] and got["y"].tolist() == [[4, 5],
                                                                  [6, 7]]
    assert mesh.global_rows(2) == (8, 2)
    with pytest.raises(ValueError, match="do not divide"):
        tshard({"x": torch.arange(6)})
    from ceigm_unet_tpu_torch.data.loader import _EpochBatches
    whole = list(_EpochBatches(20, 8, True, 3, True))
    parts = [list(_EpochBatches(20, 8, True, 3, True, (r, 4)))
             for r in range(4)]
    for b, batch in enumerate(whole):
        assert sum((p[b] for p in parts), []) == batch
    with pytest.raises(ValueError, match="do not divide"):
        _EpochBatches(20, 6, True, 3, True, (0, 4))
    with pytest.raises(ValueError, match="needs drop_last"):
        _EpochBatches(20, 8, True, 3, False, (0, 4))


def test_dryrun_refuses_more_ranks_than_cards():
    from ceigm_unet_tpu_torch.entry import dryrun_multichip
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        dryrun_multichip(2, device="cuda")


def test_dryrun_command_line(monkeypatch, capsys):
    """``python -m ceigm_unet_tpu_torch.parallel.dryrun [N] [--device]``
    runs ``run(N, device)``, 8 ranks on the cards by default as the JAX dry
    run's, and prints the JAX dry run's OK line; a failed check raises
    before it."""
    calls = []
    monkeypatch.setattr(dryrun, "run", lambda n, device: calls.append(
        (n, device)))
    dryrun.main(["2", "--device", "cpu"])
    dryrun.main([])
    assert calls == [(2, "cpu"), (8, "cuda")]
    assert capsys.readouterr().out == "dryrun_multichip: OK\n" * 2

    def failed(n, device):
        raise AssertionError("loss 1.0 in one process, 2.0 in n")
    monkeypatch.setattr(dryrun, "run", failed)
    with pytest.raises(AssertionError, match="in one process"):
        dryrun.main(["2", "--device", "cpu"])
    assert capsys.readouterr().out == ""


# --- the ring scan: 4 ranks against JAX's shard_map --------------------------

@pytest.fixture(scope="module")
def jax_ring(launched):
    """JAX's shard_map results over 4 of the 8 virtual devices on the ring
    inputs (tests/test_ring_scan.py's computations, jitted)."""
    mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    scan, grad, sp, spg = RING
    s3, s4 = P(None, None, "sp"), P(None, None, None, "sp")
    sm = lambda f, ins, outs: jax.jit(shard_map(
        f, mesh=mesh4, in_specs=ins, out_specs=outs))
    out = {}
    for reverse in (False, True):
        out["scan", reverse] = sm(
            lambda a, b: jring.sequence_parallel_scan(a, b, "sp",
                                                      reverse=reverse),
            (s4, s4), s4)(scan["a"], scan["b"])
        out["grad", reverse] = sm(
            lambda a, b, ct: jax.grad(lambda a, b: jax.lax.psum(jnp.sum(
                jring.sequence_parallel_scan(a, b, "sp", reverse=reverse)
                * ct), "sp"), argnums=(0, 1))(a, b),
            (s3,) * 3, (s3, s3))(grad["a"], grad["b"], grad["ct"])
    A, D, bias = (jnp.asarray(sp[k]) for k in ("A", "D", "bias"))
    out["sp"] = sm(lambda u, d, Bm, Cm: jring.selective_scan_sp(
        u, d, A, Bm, Cm, D, bias, delta_softplus=True),
        (s3, s3, s4, s4), s3)(sp["u"], sp["delta"], sp["B"], sp["C"])
    A = jnp.asarray(spg["A"])

    def sp_loss(u, d, Bm, Cm):
        y = jring.selective_scan_sp(u, d, A, Bm, Cm, delta_softplus=True,
                                    reverse=True)
        return jax.lax.psum(jnp.sum(y.astype(jnp.float32) ** 2), "sp")
    out["sp_grad"] = sm(lambda *xs: jax.grad(sp_loss, argnums=(0, 1, 2, 3))(
        *xs), (s3, s3, s4, s4), (s3, s3, s4, s4))(
        spg["u"], spg["delta"], spg["B"], spg["C"])
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in out.items()}


def _gathered(ring, key):
    return np.concatenate([ring[r][key] for r in range(4)], -1)


@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_parallel_scan_matches_jax_shard_map(jax_ring, ring,
                                                      reverse):
    want = jax_ring["scan", reverse]
    np.testing.assert_allclose(_gathered(ring, ("scan", reverse)), want,
                               rtol=1e-5, atol=1e-5)
    # the same arithmetic on 4 shards stacked in one process
    a, b = (ring_scan.to_shards(torch.from_numpy(RING[0][k]), 4)
            for k in ("a", "b"))
    got = ring_scan.from_shards(ring_scan.stacked_ring_scan(a, b, reverse))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_parallel_scan_grads_match_jax(jax_ring, ring, reverse):
    want = jax_ring["grad", reverse]
    for i in (0, 1):
        got = np.concatenate([ring[r]["grad", reverse][i]
                              for r in range(4)], -1)
        np.testing.assert_allclose(got, want[i], rtol=1e-5, atol=1e-5)
    # one all-gather of the summaries in each of the forward's and the
    # backward's scans, and the backward's two neighbour shifts
    for r in range(4):
        assert ring[r]["calls", reverse] == {"all_gather": 2,
                                             "batch_isend_irecv": 2}
    # the stacked ring's backward
    g = RING[1]
    a, b = (ring_scan.to_shards(torch.from_numpy(g[k]), 4).requires_grad_()
            for k in ("a", "b"))
    (ring_scan.from_shards(ring_scan.stacked_ring_scan(a, b, reverse))
     * torch.from_numpy(g["ct"])).sum().backward()
    for x, w in zip((a, b), want):
        np.testing.assert_allclose(ring_scan.from_shards(x.grad).numpy(), w,
                                   rtol=1e-5, atol=1e-5)


def test_selective_scan_sp_matches_jax(jax_ring, ring):
    got = _gathered(ring, "sp")
    np.testing.assert_allclose(got, jax_ring["sp"], rtol=1e-4, atol=1e-4)
    # and the unsharded op
    s = RING[2]
    ref = jselscan(s["u"], s["delta"], s["A"], s["B"], s["C"], s["D"],
                   s["bias"], delta_softplus=True, backend="assoc")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_selective_scan_sp_grads_match_jax(jax_ring, ring):
    for i, w in enumerate(jax_ring["sp_grad"]):
        got = np.concatenate([ring[r]["sp_grad"][i] for r in range(4)], -1)
        np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-4)


def test_dryrun_multichip_on_two_cpu_ranks():
    from ceigm_unet_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2, device="cpu")
