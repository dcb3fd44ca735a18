"""The collectives of the port's contrastive losses on gloo groups of 2, 3
and 4 CPU processes (``tests/torch_dist_worker.py``), against the JAX
package's ``axis_name`` versions under ``shard_map`` on as many of the 8
virtual CPU devices, fp32, on the same seeded features:

- ``gather_features``, ``neighbour_exchange`` (right, left) and
  ``neighbour_exchange_bidir``: each rank's output and the gradient of the
  sum over the ranks of a seeded linear function of it;
- ``ClipLoss`` and ``DistillClipLoss`` at world 2, with and without
  ``local_loss``;
- ``SigLipLoss``'s ring at world 2, 3 and 4, ``bidir`` on and off, and
  ``cos_scaling`` 2 on attn-unpool features [HW, B, D] split on axis 1.

Each rank's loss within 1e-5 relative of the JAX device's, and each rank's
input gradients (of the sum of the ranks' losses) within 1e-5 relative of
JAX's (``||got - want|| / ||want||``). The ring's mean over the ranks also
equals the one-process loss of the global batch (1e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from bcosification_tpu import losses as L
from torch_dist_worker import run_group

torch.set_num_threads(1)
B, D, HW = 2, 8, 3  # rows per rank, feature width, locations of an attn-unpool batch


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _cases():
    """{world: [(case id, job name, kwargs, JAX fn of the local blocks, the
    kwargs' keys in order, their split axes, how many take a gradient)]}."""
    rng = np.random.default_rng(0)
    cases = {2: [], 3: [], 4: []}

    def add(world, cid, job, kw, fn, keys, axes, n_grad):
        cases[world].append((cid, job, kw, fn, keys, axes, n_grad))

    w = 2
    kw = dict(img=_t(rng, w * B, D), txt=_t(rng, w * B, D), c_img=_t(rng, w * w * B, D),
              c_txt=_t(rng, w * w * B, D))

    def gather(i, t, ci, ct):
        ai, at = L.gather_features(i, t, "data")
        return (ai * ci).sum() + (at * ct).sum()

    add(2, "gather", "gather", kw, gather, ["img", "txt", "c_img", "c_txt"], [0] * 4, 2)
    for direction in ("right", "left"):
        kw = dict(x=_t(rng, w * B, D), c=_t(rng, w * B, D), direction=direction)
        add(2, f"exchange_{direction}", "exchange", kw,
            lambda x, c, d=direction: (L.neighbour_exchange(x, "data", d) * c).sum(),
            ["x", "c"], [0, 0], 1)

    def bidir(a, b, ca, cb):
        fr, fl = L.neighbour_exchange_bidir(a, b, "data")
        return (fr * ca).sum() + (fl * cb).sum()

    for world in (2, 3):
        kw = {k: _t(rng, world * B, D) for k in ("a", "b", "ca", "cb")}
        add(world, f"bidir_w{world}", "exchange_bidir", kw, bidir, ["a", "b", "ca", "cb"],
            [0] * 4, 2)
    for local in (False, True):
        kw = dict(img=_t(rng, w * B, D), txt=_t(rng, w * B, D), scale=3.0, local_loss=local)
        add(2, f"clip_local{int(local)}", "clip", kw,
            lambda i, t, lo=local: L.ClipLoss(local_loss=lo, axis_name="data")(i, t, 3.0),
            ["img", "txt"], [0, 0], 2)
        di, dt = _t(rng, w * B, D), _t(rng, w * B, D)
        kw = dict(img=_t(rng, w * B, D), txt=_t(rng, w * B, D), scale=3.0, local_loss=local,
                  distill=(di, dt, 5.0))

        def distill(i, t, di, dt, lo=local):
            c, d = L.DistillClipLoss(local_loss=lo, axis_name="data")(i, t, 3.0, di, dt, 5.0)
            return c + d

        add(2, f"distill_local{int(local)}", "clip", dict(kw, _jax_extra=(di, dt)), distill,
            ["img", "txt", "_jax_extra"], [0, 0, 0], 2)
    for world in (2, 3, 4):
        for bid in (True, False):
            kw = dict(img=_t(rng, world * B, D), txt=_t(rng, world * B, D), bidir=bid,
                      cos_scaling=0)
            add(world, f"siglip_w{world}_{'bidir' if bid else 'right'}", "siglip", kw,
                lambda i, t, b=bid: L.SigLipLoss(bidir=b, axis_name="data")(i, t, 10.0, -10.0),
                ["img", "txt"], [0, 0], 2)
    for world in (2, 4):
        kw = dict(img=_t(rng, HW, world * B, D), txt=_t(rng, world * B, D), bidir=True,
                  cos_scaling=2)
        add(world, f"siglip_w{world}_cos2", "siglip", kw,
            lambda i, t: L.SigLipLoss(axis_name="data")(i, t, 10.0, -10.0, cos_scaling=2),
            ["img", "txt"], [1, 0], 2)
    return cases


CASES = _cases()
IDS = [(world, c[0]) for world, cs in CASES.items() for c in cs]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{(world, case id): [result of each rank]}: one gloo group per world."""
    out = {}
    for world, cases in CASES.items():
        jobs = [(job, {k: v for k, v in kw.items() if not k.startswith("_")})
                for _, job, kw, *_ in cases]
        got = run_group(jobs, world, tmp_path_factory.mktemp(f"w{world}"))
        out.update({(world, c[0]): r for c, r in zip(cases, got)})
    return out


def _jax(fn, world, args, axes, n_grad):
    """(each device's value, the gradients of their sum w.r.t. the first
    ``n_grad`` arguments) of ``fn`` on the local blocks under shard_map."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    specs = tuple(P(*([None] * ax + ["data"])) for ax in axes)
    f = shard_map(lambda *a: fn(*a)[None], mesh=mesh, in_specs=specs, out_specs=P("data"))
    leaves = [jnp.asarray(np.asarray(a)) for a in args]
    vals, grads = jax.jit(lambda *ls: (f(*ls), jax.grad(lambda *a: f(*a).sum(),
                                                        argnums=tuple(range(n_grad)))(*ls)))(
        *leaves)
    return np.asarray(vals), [np.asarray(g) for g in grads]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("world,cid", IDS, ids=[f"w{w}-{c}" for w, c in IDS])
def test_collective_matches_jax(results, world, cid):
    case = next(c for c in CASES[world] if c[0] == cid)
    _, job, kw, fn, keys, axes, n_grad = case
    args = [kw[k] for k in keys]
    if keys[-1] == "_jax_extra":  # the teacher's features, split like the student's
        args = args[:-1] + list(kw["_jax_extra"])
        axes = axes[:-1] + [0, 0]
    want_vals, want_grads = _jax(fn, world, args, axes, n_grad)
    ranks = results[(world, cid)]
    got_vals = np.array([float(r["loss"]) for r in ranks])
    assert _rel(got_vals, want_vals) <= 1e-5, (got_vals, want_vals)
    for g, (want, ax) in enumerate(zip(want_grads, axes)):
        got = torch.cat([r["grads"][g] for r in ranks], dim=ax).numpy()
        assert _rel(got, want) <= 1e-5, (g, _rel(got, want))
    if job == "siglip":  # the ring's mean: the one-process loss of the global batch
        from bcosification_tpu_torch.losses import SigLipLoss

        one = SigLipLoss()(kw["img"], kw["txt"], 10.0, -10.0, cos_scaling=kw["cos_scaling"])
        assert abs(got_vals.mean() - float(one)) <= 1e-5 * abs(float(one))
    if job in ("gather", "exchange", "exchange_bidir"):  # the outputs themselves
        outs = [r["gathered" if job == "gather" else "out"] for r in ranks]
        for k in range(len(outs[0])):
            got = torch.cat([o[k] for o in outs]).numpy()
            want = _jax_outputs(job, kw, world)[k]
            np.testing.assert_array_equal(got, want)


def _jax_outputs(job, kw, world):
    """The forward outputs of the collective, every device's block in device
    order, under shard_map."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    spec = P("data")
    if job == "gather":
        fn = lambda i, t: L.gather_features(i, t, "data")  # noqa: E731
        args = (kw["img"], kw["txt"])
    elif job == "exchange":
        fn = lambda x: (L.neighbour_exchange(x, "data", kw["direction"]),)  # noqa: E731
        args = (kw["x"],)
    else:
        fn = lambda a, b: L.neighbour_exchange_bidir(a, b, "data")  # noqa: E731
        args = (kw["a"], kw["b"])
    out = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                            out_specs=tuple(spec for _ in range(2 if job != "exchange" else 1))))(
        *[jnp.asarray(a.numpy()) for a in args])
    return [np.asarray(o) for o in out]
