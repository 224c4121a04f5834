"""PyTorch port, training substrate (``repro_torch.data``, ``repro_torch.
train``, ``repro_torch.launch``) against the JAX package, on the CPU.

Held: the data stream equal bit for bit to the reference's (tokens and
labels, over vocabularies up to 50280, sequences up to 4096, seeds above
2^32 and steps above 2^31), and seekable; ``lr_at``, ``global_norm`` and
``adamw_update`` against the reference's eager functions on identical f32
inputs; ``compress`` / ``decompress`` bit for bit, with error feedback;
``allreduce_compressed`` over gloo with two processes; checkpoints written
by either package loading in the other (including the reference's f64
parameters after a jitted step); ``run``: the loss falls, the restart is
bit for bit, a resume from the reference's checkpoint; and every entry
point's default device.

Tolerances.  ``adamw_update`` is the reference's eager arithmetic op for op
in f32, so parameters and moments are equal bit for bit while the gradient
norm is under ``grad_clip`` (the clipping scale is then exactly 1).  With
clipping active the norm's sum of squares is reduced in another order by
the two frameworks, so the scale, and every updated value, may differ in
the last bits: within ``CLIP_RTOL`` = 4 f32 ulps (2^-21) relative.  The
cosine schedule's f32 ``cos`` is rounded correctly here and by XLA's own
approximation there: within 1 f32 ulp of the reference.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_lm_ref as R  # noqa: E402
import torch_train_group as G  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import train as JLT  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import compression as JCOMP  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, batch_at,  # noqa: E402
                                       host_batch_at)
from repro_torch.launch.train import RunConfig, run  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import ParamTree  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train.compression import (allreduce_compressed,  # noqa
                                           compress, decompress,
                                           init_residual)
from repro_torch.train.optimizer import (OptConfig, OptState,  # noqa: E402
                                         adamw_update, global_norm,
                                         init_opt_state, lr_at)
from repro_torch.train.pytree import tree_leaves, tree_map  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CLIP_RTOL = 2.0 ** -21


def np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def t_leaves(tree):
    return [x.detach().numpy() for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,b,s,seed,step", [
    (1000, 4, 16, 7, 42), (256, 8, 64, 0, 0), (2048, 8, 64, 0, 59),
    (50280, 2, 33, 3, 123456), (50280, 2, 4096, 11, 2 ** 31 + 5),
    (32000, 1, 4096, 5, 2 ** 31 + 7), (32000, 3, 100, 2 ** 40 + 3, 7),
    (151655, 1, 17, 1, 2 ** 32 - 1), (7, 5, 3, 9, 1)])
def test_batch_equals_reference_bit_for_bit(vocab, b, s, seed, step):
    want = JD.host_batch_at(JD.DataConfig(vocab, b, s, seed), step)
    cfg = DataConfig(vocab, b, s, seed)
    got = host_batch_at(cfg, step)
    dev = batch_at(cfg, step, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
        assert dev[k].dtype == torch.int32
        np.testing.assert_array_equal(dev[k].numpy(), want[k])


def test_data_pipeline_seekable():
    cfg = DataConfig(vocab=1000, batch=4, seq=16, seed=7)
    a = batch_at(cfg, 42, device="cpu")
    b = batch_at(cfg, 42, device="cpu")
    c = batch_at(cfg, 43, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].max()) < 1000
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    with pytest.raises(ValueError, match="uint32"):
        host_batch_at(cfg, 2 ** 32)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    cfg = OptConfig(lr=3e-3, warmup_steps=7, total_steps=50)
    jcfg = JO.OptConfig(lr=3e-3, warmup_steps=7, total_steps=50)
    for step in range(0, 55):
        got = lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        want = np.asarray(JO.lr_at(jcfg, jnp.int32(step)))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        ulps = abs(int(got.numpy().view(np.int32))
                   - int(want.view(np.int32)))
        assert ulps == 0 if step < 7 else ulps <= 1, (step, ulps)


def _tree(rng, scale):
    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * scale
    return {"w": t(6, 5), "layers": {"a": t(3, 4, 2), "b": t(3)},
            "z": t(2, 2)}


@pytest.mark.parametrize("grad_scale,clipped", [(0.05, False), (3.0, True)])
def test_adamw_matches_reference_eager(grad_scale, clipped):
    """Six steps through warmup (2 steps) into the cosine decay, fresh
    gradients each step, against the reference's eager ``adamw_update``."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 1.0)
    grads = [_tree(rng, grad_scale) for _ in range(6)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jst = JO.init_opt_state(jp)
    tp = {k: (torch.from_numpy(v.copy()) if not isinstance(v, dict) else
              {kk: torch.from_numpy(vv.copy()) for kk, vv in v.items()})
          for k, v in p0.items()}
    tst = init_opt_state(tp)
    for g in grads:
        jp, jst, jm = JO.adamw_update(JO.OptConfig(**kw), jp,
                                      jax.tree_util.tree_map(jnp.asarray, g),
                                      jst)
        tg = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), g)
        assert float(global_norm(tg)) == pytest.approx(
            float(jm["gnorm"]), rel=CLIP_RTOL)
        tp, tst, tm = adamw_update(OptConfig(**kw), tp, tg, tst)
        assert (float(jm["gnorm"]) > 1.0) == clipped
        assert int(tst.step) == int(jst.step)
        for got, want in zip(t_leaves(tp) + t_leaves(tst.m) +
                             t_leaves(tst.v), np_leaves(jp) +
                             np_leaves(jst.m) + np_leaves(jst.v)):
            assert got.dtype == want.dtype == np.float32
            if clipped:
                np.testing.assert_allclose(got, want, rtol=CLIP_RTOL,
                                           atol=0)
            else:
                np.testing.assert_array_equal(got, want)


def test_adamw_updates_in_place_and_consumes_grads():
    p = {"a": torch.ones(4), "b": {"c": torch.full((2, 2), 2.0)}}
    ids = [x.data_ptr() for x in tree_leaves(p)]
    st = init_opt_state(p)
    mids = [x.data_ptr() for x in tree_leaves(st.m)]
    out, st2, m = adamw_update(OptConfig(), p, {"a": torch.ones(4),
                                                "b": {"c": torch.ones(2, 2)}},
                               st)
    assert out is p and [x.data_ptr() for x in tree_leaves(p)] == ids
    assert [x.data_ptr() for x in tree_leaves(st2.m)] == mids
    assert int(st.step) == 0 and int(st2.step) == 1
    assert st2.step.device.type == "cpu"
    assert set(m) == {"gnorm", "lr"}


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compress_decompress_equal_reference():
    rng = np.random.default_rng(3)
    g = _tree(rng, 2.0)
    g["w"][0, :3] = [0.5, -0.5, 1.5]                  # ties after scaling
    r = _tree(rng, 0.01)
    jq, js, jr = JCOMP.compress(jax.tree_util.tree_map(jnp.asarray, g),
                                jax.tree_util.tree_map(jnp.asarray, r))
    tg = jax.tree_util.tree_map(torch.from_numpy, g)
    q, s, res = compress(tg, jax.tree_util.tree_map(torch.from_numpy, r))
    for got, want in ((q, jq), (s, js), (res, jr),
                      (decompress(q, s), JCOMP.decompress(jq, js))):
        for a, b in zip(t_leaves(got), np_leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert all(x.dtype == torch.float32 and not x.any()
               for x in tree_leaves(init_residual(tg)))


def test_compression_error_feedback():
    """Error feedback: the quantization error is carried, so the *sum* over
    steps converges to the true gradient sum."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64))
                               .astype(np.float32))}
    res = init_residual(g)
    total_sent = torch.zeros((64, 64))
    for _ in range(20):
        q, s, res = compress(g, res)
        total_sent = total_sent + decompress(q, s)["w"]
    err = float((total_sent / 20 - g["w"]).abs().max())
    assert err < 5e-3, err


def test_allreduce_compressed_over_gloo(tmp_path):
    out = tmp_path / "group.pt"
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, G.__file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = torch.load(out, weights_only=False)
    payloads, residuals = [], []
    for rank in range(G.WORLD):
        q, s, r = compress(*G.rank_inputs(rank))
        payloads.append(t_leaves(decompress(q, s)))
        residuals.append(t_leaves(r))
    mean = [(a + b) / np.float32(2) for a, b in zip(*payloads)]
    for rank, rec in enumerate(got):
        for a, b in zip(t_leaves(rec["summed"]), mean):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t_leaves(rec["residual"]), residuals[rank]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _port_state(arch):
    """A smoke model's port parameters (from the reference's tree) and an
    optimizer state after one update (moments not zero)."""
    cfg = smoke_config(arch)
    params = params_from_jax(cfg, R.tree(arch), device="cpu")
    opt = init_opt_state(params)
    grads = tree_map(lambda x: torch.full(x.shape, 0.01), params)
    params, opt, _ = adamw_update(OptConfig(), params, grads, opt)
    return cfg, params, opt


def test_port_checkpoint_loads_in_reference(tmp_path):
    arch = "mamba2-2.7b"
    cfg, params, opt = _port_state(arch)
    C.save_checkpoint(tmp_path / "step_1", 1, params, opt, extra={"x": 1})
    jtree = R.tree(arch)
    step, jp, jo = JC.load_checkpoint(tmp_path / "step_1", jtree,
                                      JO.init_opt_state(jtree))
    assert step == 1 and int(jo.step) == 1
    for a, b in zip(np_leaves(jp), t_leaves(params)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(np_leaves(jo.m) + np_leaves(jo.v),
                    t_leaves(opt.m) + t_leaves(opt.v)):
        np.testing.assert_array_equal(a, b)
    # and back into the port, as a ParamTree on the named device
    step, p2, o2 = C.load_checkpoint(tmp_path / "step_1", params, opt,
                                     device="cpu")
    assert step == 1 and isinstance(p2, ParamTree) and int(o2.step) == 1
    for a, b in zip(t_leaves(p2) + t_leaves(o2.m) + t_leaves(o2.v),
                    t_leaves(params) + t_leaves(opt.m) + t_leaves(opt.v)):
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_after_jitted_step_loads_in_port(tmp_path):
    """The reference's jitted step returns f64 parameters (x64), which its
    checkpoint keeps; the port loads them as f32."""
    arch = "minitron-4b"
    jcfg = j_smoke_config(arch)
    jtree = R.tree(arch)
    step_fn = jax.jit(JTS.make_train_step(jcfg, JO.OptConfig(),
                                          JTS.StepConfig(remat=False)))
    b = JD.host_batch_at(JD.DataConfig(jcfg.vocab, 2, 16), 0)
    jp, jo, _ = step_fn(jtree, JO.init_opt_state(jtree), b)
    assert {x.dtype for x in np_leaves(jp)} == {np.dtype(np.float64)}
    JC.save_checkpoint(tmp_path / "step_1", 1, jp, jo)
    cfg = smoke_config(arch)
    shapes = T.abstract_params(cfg)
    step, params, opt = C.load_checkpoint(
        tmp_path / "step_1", shapes, OptState(None, shapes, shapes),
        device="cpu")
    assert step == 1 and int(opt.step) == 1 and isinstance(params, dict)
    for a, b in zip(t_leaves(params), np_leaves(jp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b.astype(np.float32))
    for a, b in zip(t_leaves(opt.m) + t_leaves(opt.v),
                    np_leaves(jo.m) + np_leaves(jo.v)):
        np.testing.assert_array_equal(a, b)
    # a wrong template is refused
    with pytest.raises(ValueError, match="template"):
        small = T.abstract_params(smoke_config("mamba2-2.7b"))
        C.load_checkpoint(tmp_path / "step_1", small,
                          OptState(None, small, small), device="cpu")


def test_latest_step(tmp_path):
    assert C.latest_step(tmp_path / "none") is None
    assert C.latest_step(tmp_path) is None
    _, params, opt = _port_state("minitron-4b")
    for s in (5, 15, 10):
        C.save_checkpoint(tmp_path / f"step_{s}", s, params, opt)
    (tmp_path / "step_99").mkdir()                     # no manifest: ignored
    assert C.latest_step(tmp_path) == JC.latest_step(tmp_path) == 15
    assert not list(tmp_path.glob("step_*/*.tmp*"))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg = smoke_config("minitron-4b")
    _, _, losses = run(cfg, RunConfig(steps=30, ckpt_dir=None),
                       OptConfig(lr=3e-3, warmup_steps=5, total_steps=30),
                       verbose=False, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_ft_restart_bit_exact(tmp_path):
    """Preemption simulation: train 10; vs train 5 -> 'crash' -> resume ->
    10.  Same data (pure function of step) + same ops => identical
    parameters and moments."""
    cfg = smoke_config("qwen2.5-32b")
    p_full, o_full, l_full = run(cfg, RunConfig(steps=10, seed=3),
                                 verbose=False, device="cpu")
    ckpt = str(tmp_path / "ck")
    _, _, l_half = run(cfg, RunConfig(steps=5, ckpt_every=5, ckpt_dir=ckpt,
                                      seed=3), verbose=False, device="cpu")
    p_res, o_res, l_res = run(cfg, RunConfig(steps=10, ckpt_every=5,
                                             ckpt_dir=ckpt, seed=3),
                              verbose=False, device="cpu")
    assert l_half + l_res == l_full
    assert int(o_res.step) == int(o_full.step) == 10
    for a, b in zip(t_leaves(p_full) + t_leaves(o_full.m) +
                    t_leaves(o_full.v), t_leaves(p_res) + t_leaves(o_res.m)
                    + t_leaves(o_res.v)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-medium"])
def test_run_feeds_frontend_archs(arch):
    """The synthetic stream has no frontend embeddings; ``run`` draws
    seeded ones per step for the enc-dec and vision-stub models."""
    _, opt, losses = run(smoke_config(arch), RunConfig(steps=2),
                         verbose=False, device="cpu",
                         data_cfg=DataConfig(256, 2, 16))
    assert int(opt.step) == 2 and np.isfinite(losses).all()


def test_resume_from_reference_checkpoint(tmp_path, capsys):
    """A job checkpointed by the reference resumes in the port, on the
    same token stream."""
    arch = "qwen2.5-32b"
    ckpt = str(tmp_path / "ck")
    JLT.run(j_smoke_config(arch), JLT.RunConfig(steps=2, ckpt_every=2,
                                                ckpt_dir=ckpt, seed=1),
            verbose=False)
    _, opt, losses = run(smoke_config(arch), RunConfig(
        steps=4, ckpt_every=2, ckpt_dir=ckpt, seed=1), device="cpu")
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(opt.step) == 4 and len(losses) == 2
    assert C.latest_step(ckpt) == 4
    jtree = JT.init_params(j_smoke_config(arch), jax.random.PRNGKey(1))
    step, jp, _ = JC.load_checkpoint(tmp_path / "ck" / "step_4", jtree,
                                     JO.init_opt_state(jtree))
    assert step == 4 and {x.dtype for x in np_leaves(jp)} == {
        np.dtype(np.float32)}


def test_entry_points_default_to_cuda():
    cfg = smoke_config("minitron-4b")
    if torch.cuda.is_available():
        assert batch_at(DataConfig(16, 1, 4), 0)["tokens"].is_cuda
        return
    for call in (lambda: batch_at(DataConfig(16, 1, 4), 0),
                 lambda: run(cfg, RunConfig(steps=1), verbose=False),
                 lambda: C.load_checkpoint("nowhere", {}, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_import_loads_neither_jax_nor_repro():
    mods = ["repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.train_step", "repro_torch.train.checkpoint",
            "repro_torch.train.compression", "repro_torch.launch",
            "repro_torch.launch.train"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\nassert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
