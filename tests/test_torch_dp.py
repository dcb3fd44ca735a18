"""Data parallelism of the port (``parallel/dp.py``) on one gloo group of 2
CPU processes (``tests/torch_dist_worker.py``), fp32, against the JAX
package on a 2-device data mesh of the 8 virtual CPU devices and against
the port's one-process step on the concatenated batch:

- two supervised steps of the small flagship (BnUncV2's train-mode
  moments, AGC, EMA, Adam with the warm-up cosine, calibrated gammas): the
  loss (1e-5), the parameters after the two steps (1e-5 absolute against
  Adam steps of ~1e-3) and the BN statistics (1e-5
  relative), against JAX ``make_train_step`` on the sharded global batch
  and against the port's one-process steps; both ranks hold the same
  model, bit for bit;
- gradient accumulation over 2 micro-batches, with AGC (the gradients
  averaged at each micro-step) and without (averaged once per update),
  against the one-process ``MultiSteps`` mean;
- the KD step of the attn-unpool student (its [HW, B, D] features split on
  the batch axis 1) in "global" and "ring" mode: the loss against JAX
  ``make_kd_train_step(loss_mode=..., mesh=...)`` (1e-5) and against the
  one-process step, whose Adam first moment and BN statistics it matches;
- ``Trainer.fit`` under the group (2 epochs of the tiny net with EMA):
  its history equals the one-process fit's (1e-5); rank 1 writes nothing;
  a resumed 3rd epoch, restored by both ranks from rank 0's directory,
  equals the one-process 3-epoch fit, and the checkpoint loads in one
  process;
- the data-parallel dry run (``parallel/dryrun.py``) against itself in one
  process;
- the per-process splits: ``split_by_process``'s sampler indices and
  ``split_shards_by_process``'s shards equal the JAX package's for each
  rank (``jax.process_index`` / ``process_count`` patched, as
  tests/test_multihost_io.py does);
- the launcher (``run_distributed.initialize_distributed``): a failed join
  is fatal unless ``--single-host-ok``, a partial env contract is ignored,
  a group of another size than ``WORLD_SIZE`` raises;
- the b optimizer's lr times the world, the EMA decay and the linear-b
  schedule over the global batch on the split path.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as worker
from test_torch_training import _flagship_batch, _jax_recipe, _leaves, _rel
from torch_port_helpers import small_pair

torch.set_num_threads(1)
WORLD = 2


def _batch(size, n, seed):
    x, label = _flagship_batch(size, n=n, seed=seed)
    return {"image": torch.from_numpy(x), "label": torch.from_numpy(label).long()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The models, the inputs, and every job's result on each of the 2 ranks."""
    from test_torch_kd import images as kd_images
    from test_torch_kd import student_pair, teacher_pair

    net, variables, tnet, _ = small_pair("resnet50", ("bottleneck", (1, 1)), 32)
    batches = [_batch(32, 4, 10), _batch(32, 4, 11)]
    jt, tvars, teacher = teacher_pair()
    students = {True: student_pair(True)}
    kd_x = torch.from_numpy(kd_images(4))
    kd_cases = [(True, "global"), (True, "ring")]
    base = tmp_path_factory.mktemp("dp")
    tiny = worker.TinyNet()
    jobs = [("train_steps", dict(model=tnet, batches=batches)),
            ("train_steps", dict(model=tnet, batches=batches, use_agc=False, ema=False,
                                 accumulate=2)),
            ("train_steps", dict(model=tnet, batches=batches, ema=False, accumulate=2))]
    n_kd = len(kd_cases)
    jobs += [("kd_step", dict(student=students[unpool][2], teacher=teacher, images=kd_x,
                              cos_power=2 if unpool else 0, loss_mode=mode))
             for unpool, mode in kd_cases]
    jobs += [("fit", dict(model=tiny, save_dir=str(base / "fit"), max_epochs=2, resume=False,
                          per_rank_dir=True)),
             ("fit", dict(model=tiny, save_dir=str(base / "fit" / "rank0"), max_epochs=3,
                          resume=True)),
             ("dryrun", dict(save_dir=str(base / "dryrun"), model=tnet))]
    assert len(jobs) == 6 + n_kd
    results = worker.run_group(jobs, WORLD, base / "group")
    return dict(net=net, variables=variables, tnet=tnet, batches=batches, jt=jt, tvars=tvars,
                teacher=teacher, students=students, kd_x=kd_x, kd_cases=kd_cases, tiny=tiny,
                base=base, jobs=jobs, results=results)


def _same_on_every_rank(ranks, key="model"):
    for name, t in ranks[0][key].items():
        for other in ranks[1:]:
            assert torch.equal(t, other[key][name]), name


def _close_states(got, want, atol=1e-5):
    for name, t in want.items():
        if t.is_floating_point():
            a, b = got[name].double().numpy(), t.double().numpy()
            if "running" in name:
                assert _rel(a, b) <= 1e-5, name
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def test_dp_train_step_matches_jax_and_one_process(setup):
    """Two DP steps on 2 ranks: JAX's step on a 2-device data mesh over the
    same global batch, and the port's one-process steps on it."""
    from bcosification_tpu.parallel import mesh as mesh_lib
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables

    ranks = setup["results"][0]
    _same_on_every_rank(ranks)
    one = worker.job_train_steps(**setup["jobs"][0][1])  # no group: one process
    for got, want in zip(ranks[0]["metrics"], one["metrics"]):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert abs(got["acc1"] - want["acc1"]) <= 1e-6
    _close_states(ranks[0]["model"], one["model"])
    _close_states(ranks[0]["ema"], one["ema"])

    criterion, tx = _jax_recipe(amp=False)
    mesh = mesh_lib.make_mesh(WORLD)
    jstep = jsteps.make_train_step(setup["net"], criterion, tx, use_agc=True, ema_decay=0.9,
                                   ema_steps=1, donate=False)
    jstate = mesh_lib.replicate(jsteps.create_train_state(setup["variables"], tx,
                                                          with_ema=True), mesh)
    for batch, got in zip(setup["batches"], ranks[0]["metrics"]):
        jb = mesh_lib.shard_batch({"image": batch["image"].numpy(),
                                   "label": batch["label"].numpy().astype(np.int32)}, mesh)
        jstate, jm = jstep(jstate, jb)
        assert abs(got["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    tnet = copy.deepcopy(setup["tnet"])
    tnet.load_state_dict(ranks[0]["model"])
    got = to_jax_variables(tnet)
    for coll, tree in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        want = {".".join(p): a for p, a in _leaves(jax.tree_util.tree_map(np.asarray, tree))}
        for name, arr in ((".".join(p), a) for p, a in _leaves(got[coll])):
            if coll == "params":
                np.testing.assert_allclose(arr, want[name], rtol=0, atol=1e-5, err_msg=name)
            else:
                assert _rel(arr, want[name]) <= 1e-5, name


@pytest.mark.parametrize("job", [1, 2], ids=["no_agc_deferred", "agc_each_micro_step"])
def test_accumulated_dp_step_matches_one_process(setup, job):
    """Accumulation k = 2 under the group equals the one-process MultiSteps
    mean: without a clip the micro-steps do not all-reduce (the mean is
    averaged once), with AGC each micro-step's gradient is the global one."""
    ranks = setup["results"][job]
    _same_on_every_rank(ranks)
    one = worker.job_train_steps(**setup["jobs"][job][1])
    for got, want in zip(ranks[0]["metrics"], one["metrics"]):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    _close_states(ranks[0]["model"], one["model"])


@pytest.mark.parametrize("case", range(2), ids=["unpool-global", "unpool-ring"])
def test_kd_step_matches_jax_and_one_process(setup, case):
    """One KD step on 2 ranks in the loss mode: its loss against JAX's step on
    a 2-device mesh in the same mode and against the one-process step; Adam's
    first moment (the clipped gradient times 0.1) against the one-process
    step's within 1e-4 of the largest leaf's norm (this net's fp32 gradients
    move ~2e-5 of it under rounding-sized input noise, tests/test_torch_kd.py),
    and the BN statistics within 1e-5."""
    from bcosification_tpu.parallel import mesh as mesh_lib
    from bcosification_tpu.training import kd as jkd
    from bcosification_tpu.training import steps as jsteps
    from test_torch_kd import _recipe

    unpool, mode = setup["kd_cases"][case]
    ranks = setup["results"][3 + case]
    _same_on_every_rank(ranks)
    one = worker.job_kd_step(**setup["jobs"][3 + case][1])
    assert abs(ranks[0]["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    top = max(float(m.norm()) for m in one["mu"].values())
    for name, m in one["mu"].items():
        assert float((ranks[0]["mu"][name] - m).norm()) <= 1e-4 * top, name
    for name, t in one["model"].items():
        if "running" in name:
            assert _rel(ranks[0]["model"][name].numpy(), t.numpy()) <= 1e-5, name

    js, svars, _ = setup["students"][unpool]
    jopt, jsched = _recipe(port=False)
    tx = jopt.create(jsched, svars["params"])
    mesh = mesh_lib.make_mesh(WORLD)
    jstep = jkd.make_kd_train_step(js, setup["jt"], setup["tvars"], tx,
                                   cos_power=2 if unpool else 0, loss_mode=mode, mesh=mesh,
                                   donate=False)
    jstate = mesh_lib.replicate(jsteps.create_train_state(svars, tx), mesh)
    _, jm = jstep(jstate, mesh_lib.shard_batch({"image": setup["kd_x"].numpy()}, mesh))
    assert abs(ranks[0]["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))


def test_fit_under_a_group(setup):
    """Trainer.fit on 2 ranks equals the one-process fit on the same data;
    only rank 0 writes; both ranks resume from rank 0's directory, and its
    checkpoint loads in one process."""
    from bcosification_tpu_torch.training import steps as steps_lib
    from bcosification_tpu_torch.training.checkpointing import CheckpointManager
    from bcosification_tpu_torch.training.trainer import Trainer

    first, resumed = setup["results"][5], setup["results"][6]
    assert [r["exists"] for r in first] == [True, False]  # rank 1 wrote nothing
    _same_on_every_rank(first)
    _same_on_every_rank(resumed)
    for epochs, ranks in ((2, first), (3, resumed)):  # the one-process run, resumed alike
        trainer = Trainer(worker.experiment(setup["base"] / "one"), device="cpu")
        state = trainer.fit(setup["tiny"], worker.SynthDataModule(), max_epochs=epochs,
                            resume=epochs == 3)
        want, got = trainer.metrics.history, ranks[0]["history"]
        for key in ("train_loss", "train_acc1", "val_acc1", "val_acc5", "val_loss",
                    "val_loss_ema", "initial_val_loss", "lr"):
            np.testing.assert_allclose([v for _, v in got[key]], [v for _, v in want[key]],
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        _close_states(ranks[0]["model"], state.model.state_dict())
    ckpt = CheckpointManager(str(setup["base"] / "fit" / "rank0"))
    restored, epoch = ckpt.restore("last")
    assert epoch == 2
    state = steps_lib.create_train_state(setup["tiny"],
                                         lambda m: torch.optim.Adam(m.parameters()))
    state.model.load_state_dict(restored["model"])
    for name, t in resumed[0]["model"].items():
        assert torch.equal(state.model.state_dict()[name], t), name


def test_dryrun_dp_matches_one_process(setup, tmp_path):
    """The dry run's step, resume, explanation and SigLIP ring on 2 ranks
    equal the dry run in one process on the same global batches."""
    from bcosification_tpu_torch.parallel.dryrun import dryrun_dp

    ranks = setup["results"][7]
    one = dryrun_dp(str(tmp_path), setup["tnet"], per_rank=2 * WORLD)
    for got in ranks:
        assert got["resume_delta"] < 1e-6
        assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert abs(got["siglip"] - one["siglip"]) <= 1e-5 * abs(one["siglip"])
        assert _rel(got["w"].numpy(), one["w"].numpy()) <= 1e-5
        _close_states(got["params"], one["params"])


@pytest.mark.parametrize("ra_reps", [None, 2], ids=["split", "ra2"])
@pytest.mark.parametrize("rank", [0, 1])
def test_split_by_process_indices_match_jax(monkeypatch, rank, ra_reps):
    """The train sampler of a split_by_process data module at each rank of 2
    draws the JAX module's indices."""
    from bcosification_tpu.data import datamodules as jdm
    from bcosification_tpu_torch.data import datamodules as tdm
    from bcosification_tpu_torch.parallel import dp

    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    monkeypatch.setattr(dp, "rank", lambda: rank)
    monkeypatch.setattr(dp, "world_size", lambda: WORLD)
    config = {"batch_size": 4, "split_by_process": True, "ra_repetitions": ra_reps}
    got = []
    for mod in (jdm, tdm):
        dm = mod.ImageNetDataModule(dict(config))
        dm.train_dataset = list(range(517))
        sampler = dm.get_train_sampler(seed=3)
        sampler.set_epoch(1)
        got.append(list(sampler))
    assert got[0] == got[1] and len(got[1]) > 0


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_split_shards_by_process_matches_jax(monkeypatch, tmp_path, rank):
    """split_shards_by_process at each rank of 3: the JAX module's train
    shards ([rank::3]), a repeating stream, and the whole validation set."""
    from bcosification_tpu import settings as jsettings
    from bcosification_tpu.data import cc3m as jcc3m
    from bcosification_tpu.data import presets as jpresets
    from bcosification_tpu_torch.parallel import dp
    from test_torch_cc3m import _cc3m_tree, _datamodule, write_shard

    rng = np.random.default_rng(0)
    shards = [write_shard(tmp_path / f"{s:05d}.tar", [f"{s:05d}"], rng) for s in range(3)]
    root = _cc3m_tree(tmp_path, shards)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(dp, "rank", lambda: rank)
    monkeypatch.setattr(dp, "world_size", lambda: 3)
    monkeypatch.setattr(jsettings, "CC3M_PATH", str(root))
    preset = jpresets.CLIPBcosImageNetClassificationPresetEval(crop_size=16, resize_size=20)
    jdm = jcc3m.CC3MDataModule({"data_root": str(root), "batch_size": 4,
                                "train_transform": preset, "test_transform": preset,
                                "split_shards_by_process": True})
    tdm = _datamodule(root, split_shards_by_process=True)
    for dm in (jdm, tdm):
        dm.setup("fit")
    assert [str(s) for s in tdm.train_dataset.shards] == [str(s) for s in jdm.train_dataset.shards]
    assert len(tdm.train_dataset.shards) == 111 - (rank == 2)
    assert tdm.train_dataset.repeat and jdm.train_dataset.repeat
    assert [str(s) for s in tdm.eval_dataset.shards] == [str(s) for s in jdm.eval_dataset.shards]


def test_launcher_env_contract(monkeypatch, capsys):
    """initialize_distributed: no contract (or a malformed one) is fatal
    unless --single-host-ok, which it consumes; a partial contract is
    ignored with a message; a joined group of another size than WORLD_SIZE
    raises; a full contract passes rank and world to the join."""
    from bcosification_tpu_torch.run_distributed import initialize_distributed

    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    calls = []

    def fake_init(device, **kwargs):
        calls.append(kwargs)

    with pytest.raises(RuntimeError, match="single-host-ok"):
        initialize_distributed(argv=["train"], _initialize=fake_init)
    argv = ["train", "--single-host-ok", "--amp"]
    assert initialize_distributed(argv=argv, _initialize=fake_init) is False
    assert argv == ["train", "--amp"] and calls == []
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="single-host-ok"):
        initialize_distributed(argv=["train"], _initialize=fake_init)
    assert "ignoring partial" in capsys.readouterr().out and calls == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "x")
    with pytest.raises(RuntimeError, match="malformed"):
        initialize_distributed(argv=["train"], _initialize=fake_init)
    assert initialize_distributed(argv=["t", "--single-host-ok"], _initialize=fake_init) is False
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is 2"):
        initialize_distributed(argv=["train"], _initialize=fake_init)  # joined nothing
    assert calls == [{"rank": 1, "world_size": 2}]


def test_world_scales_the_b_optimizer_and_the_global_batch_formulas():
    """_make_optimizers multiplies the b optimizer's lr by the data-parallel
    world (JAX _make_optimizers' dp_world); _b_schedule's increment is
    b_lr * world * batch; the EMA decay takes the world as JAX's does."""
    from bcosification_tpu.training.ema import adjusted_ema_decay as jema
    from bcosification_tpu_torch.optim import OptimizerFactory
    from bcosification_tpu_torch.training.ema import adjusted_ema_decay
    from bcosification_tpu_torch.training.trainer import _b_schedule, _make_optimizers

    config = {"optimizer": OptimizerFactory("Adam", 1e-3), "lr_scheduler": None,
              "model": {"bcosify_args": {"manual_optim": True, "linear_b": True,
                                         "b_lr": 1e-4}}}
    _, b1, _ = _make_optimizers(config, 10)
    _, b4, _ = _make_optimizers(config, 10, dp_world=4)
    assert b4.lr == pytest.approx(4 * b1.lr) and b4.name == b1.name
    assert {k: v for k, v in b4.args.items() if k != "lr"} == {
        k: v for k, v in b1.args.items() if k != "lr"}
    s1, s2 = _b_schedule(config, 8, 100), _b_schedule(config, 8, 100, world_size=2)
    assert s2(1) - s2(0) == pytest.approx(2 * (s1(1) - s1(0)))
    assert adjusted_ema_decay(0.9999, 2, 8, 90) == pytest.approx(jema(0.9999, 2, 8, 90))


def test_one_rank_gloo_group_step_equals_the_plain_step(setup):
    """In a group of one the collectives run (the BN moments, the gradients
    and the metrics all-reduced, rank 0's weights broadcast), each the
    identity: two steps equal the steps without a group bit for bit."""
    from bcosification_tpu_torch.parallel import dp

    plain = worker.job_train_steps(**setup["jobs"][0][1])
    init = f"tcp://127.0.0.1:{worker._free_port()}"
    dp.init_process_group("cpu", rank=0, world_size=1, init_method=init)
    try:
        assert dp.is_initialized() and dp.world_size() == 1
        grouped = worker.job_train_steps(**setup["jobs"][0][1])
    finally:
        dp.destroy_process_group()
    assert grouped["metrics"] == plain["metrics"]
    for key in ("model", "ema"):
        for name, t in plain[key].items():
            assert torch.equal(grouped[key][name], t), name
