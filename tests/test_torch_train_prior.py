"""The port's prior training (``kandinsky2_tpu_torch/train/train_prior.py``,
the prior half of ``train/data.py`` and the ``train_prior_cli`` CLI)
against the JAX package's, in fp32 on the CPU: one step of a tiny
``PriorTransformer`` on ``train_configs/config_prior.yaml``'s diffusion
config with the JAX step's t and noise (loss, gradient, EMA), a killed and
resumed run against an uninterrupted one, the prior-mode loader's batches,
and the CLI end to end on a tiny YAML with the stand-in BPE tokenizer."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from kandinsky2_tpu.configs import schedule_kwargs as jskw
from kandinsky2_tpu.diffusion import gaussian as jg
from kandinsky2_tpu.models.prior import PriorTransformer as JPrior
from kandinsky2_tpu.train import resample as jres
from kandinsky2_tpu.train.train_prior import make_prior_train_step as jmake_step
from kandinsky2_tpu_torch.models.prior import PriorTransformer as TPrior
from kandinsky2_tpu_torch.train import checkpoint as tckpt
from kandinsky2_tpu_torch.train import train_prior as ttrain
from kandinsky2_tpu_torch.train import train_prior_cli as tcli
from kandinsky2_tpu_torch.utils import stub_tokenizers
from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict, load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params

T = lambda a: torch.from_numpy(np.array(a))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "train_configs", "config_prior.yaml")) as _f:
    YAML = yaml.safe_load(_f)
DCFG = YAML["model_config"]["diffusion"]
HP = dict(text_ctx=8, xf_width=32, xf_layers=2, xf_heads=2, xf_final_ln=True,
          clip_dim=16, clip_xf_width=24)
B, LR = 2, 1e-2


def _batch(seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, HP["text_ctx"]), bool)
    mask[1, 5:] = False
    return {"image_emb": rng.randn(B, HP["clip_dim"]).astype(np.float32),
            "txt_feat": rng.randn(B, HP["clip_dim"]).astype(np.float32),
            "txt_feat_seq": rng.randn(B, HP["text_ctx"], HP["clip_xf_width"]).astype(
                np.float32),
            "mask": mask}


def _torch_batch(batch):
    return {k: T(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """The tiny prior's parameters, one JAX step (SGD at 1e-2, EMA) with
    its draws, and JAX's loss and gradient at those draws."""
    jp = JPrior(**HP, dtype=jnp.float32)
    batch = _batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(jp.init, jax.random.PRNGKey(0), jb["image_emb"],
                            jnp.zeros((B,)), jb["txt_feat"], jb["txt_feat_seq"],
                            jb["mask"])
    params = numpy_params(shapes["params"], 4)
    init_state, step = jmake_step(jp, DCFG, optax.sgd(LR), ema_decay=0.9999)
    state, metrics = jax.jit(step)(init_state(params), jb, jax.random.PRNGKey(0))
    rng_t, rng_n = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))
    t, _ = jres.uniform_sample(rng_t, 1000, B)
    noise = jax.random.normal(rng_n, (B, HP["clip_dim"]), jnp.float32)
    skw = jskw(DCFG, "")
    sched = jg.make_schedule(**skw["make_schedule"])

    def loss_fn(p):
        terms = jg.training_losses(
            sched, lambda x, tm: jp.apply({"params": p}, x, tm, text_emb=jb["txt_feat"],
                                          text_enc=jb["txt_feat_seq"], mask=jb["mask"]),
            jb["image_emb"], t, noise, mean_type=skw["mean_type"],
            var_type=skw["var_type"], loss_type=skw["loss_type"], channel_axis=-1)
        return jnp.mean(terms["loss"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(params=params, batch=batch, t=np.asarray(t), noise=np.asarray(noise),
                state=state, metrics=metrics, loss=loss, grads=grads)


def _tprior(params):
    return load_jax_params(TPrior(**HP), params)


def test_one_prior_step_matches_jax(jax_ref):
    """Loss 1e-4, every gradient 1e-4 of its tensor's largest, the
    parameters after SGD and the EMA (warm-up decay 0.1 at step 0) 1e-5."""
    prior = _tprior(jax_ref["params"])
    init_state, step = ttrain.make_prior_train_step(
        prior, DCFG, lambda ps: torch.optim.SGD(ps, lr=LR), ema_decay=0.9999)
    state = init_state()
    grads = {}
    state.optimizer.register_step_pre_hook(lambda o, a, kw: grads.update(
        {n: p.grad.clone() for n, p in prior.named_parameters()}))
    m = step(state, _torch_batch(jax_ref["batch"]), t=T(jax_ref["t"]),
             noise=T(jax_ref["noise"]))
    assert_close(m["loss"], jax_ref["loss"], MODULE_TOL, "loss")
    assert_close(m["loss"], jax_ref["metrics"]["loss"], MODULE_TOL, "step loss")
    want = jax_to_state_dict(jax_ref["grads"], prior)
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-6), name
    new = jax_to_state_dict(jax_ref["state"].params, prior)
    ema = jax_to_state_dict(jax_ref["state"].ema_params, prior)
    for name, p in prior.named_parameters():
        assert_close(p, new[name], 1e-5, name)
        assert_close(state.ema_params[name], ema[name], 1e-5, f"ema {name}")
    assert state.step == 1 and int(jax_ref["state"].step) == 1


def _loop(params, batches, save_path, save_every):
    return ttrain.train_prior(
        prior=_tprior(params), diffusion_config=DCFG, loader=batches,
        prepare_batch=_torch_batch, save_every=save_every, save_path=str(save_path),
        log_every=1000)


def test_kill_and_resume_is_bitwise_identical(jax_ref, tmp_path):
    """Four Adafactor steps drawing from the state's generator, against
    two, a save, a fresh restart and two more: params, EMA, optimizer
    state, step and generator bitwise equal; the export is the params."""
    batches = [_batch(10 + i) for i in range(4)]
    straight = _loop(jax_ref["params"], batches, tmp_path / "straight", 1000)
    _loop(jax_ref["params"], batches[:2], tmp_path / "resumed", 2)
    assert tckpt.latest_train_state(str(tmp_path / "resumed"))[1] == 2
    resumed = _loop(jax_ref["params"], batches[2:], tmp_path / "resumed", 1000)
    assert straight.step == resumed.step == 4
    a, b = straight.state_dict(), resumed.state_dict()
    for part in ("params", "ema"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(b["optimizer"]["state"][i][k])), (i, k)
    assert torch.equal(a["generator"], b["generator"])
    fname, step = tckpt.latest_checkpoint(str(tmp_path / "resumed"))
    assert step == 4
    for k, v in tckpt.load_checkpoint(fname).items():
        assert torch.equal(v, a["params"][k]), k


def _pictures(tmp_path, n, seed):
    rng = np.random.RandomState(seed)
    rows = ["image_name,caption"]
    for i in range(n):
        path = tmp_path / f"{i}.png"
        from PIL import Image

        Image.fromarray(rng.randint(0, 256, (40 + 8 * i, 48, 3), np.uint8)).save(path)
        rows.append(f"{path},picture number {i} of {n}")
    (tmp_path / "data.csv").write_text("\n".join(rows) + "\n")
    return str(tmp_path / "data.csv")


def test_prior_loader_batches_match_jax(tmp_path):
    """Prior mode: the same shuffles, text drops, CLIP crops, BPE tokens and
    bool masks as the JAX package's loader, over two epochs."""
    from kandinsky2_tpu.train import data as jdata
    from kandinsky2_tpu_torch.train import data as tdata

    kw = dict(csv_path=_pictures(tmp_path, 5, 12), tokenizer=stub_tokenizers(64)[1],
              clip_image_size=28, drop_text_prob=0.5, seq_len=12, mode="prior")
    loaders = [lib.create_loader(lib.TextImageDataset(**kw), batch_size=2)
               for lib in (tdata, jdata)]
    for _ in range(2):
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"clip_image", "tokens", "mask"}
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cli_on_a_tiny_yaml(tmp_path):
    """``python -m kandinsky2_tpu_torch.train.train_prior_cli --config`` on
    ``config_prior.yaml`` with a tiny prior (the CLIP towers at their
    defaults, the stand-in BPE tokenizer) over a seeded CSV of two
    pictures: two steps, the whole state and the weights saved."""
    cfg = yaml.safe_load(yaml.safe_dump(YAML))
    cfg["model_config"]["model"]["hparams"].update(xf_width=32, xf_layers=2, xf_heads=2)
    cfg.update(num_epochs=1, save_path=str(tmp_path / "ckpt"))
    cfg["data"]["train"]["df_path"] = _pictures(tmp_path, 2, 13)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    tcli.main(["--config", str(tmp_path / "tiny.yaml"), "--device", "cpu"])
    assert tckpt.latest_train_state(str(tmp_path / "ckpt"))[1] == 2
    fname, step = tckpt.latest_checkpoint(str(tmp_path / "ckpt"))
    weights = tckpt.load_checkpoint(fname)
    assert step == 2 and weights["out_proj.weight"].shape == (768, 32)
    assert all(torch.isfinite(v).all() for v in weights.values())


def test_cli_trains_with_adamw(tmp_path):
    """The prior CLI's ``run`` on the tiny YAML with ``optax.adamw`` at 1e-4:
    two steps, every prior tensor moved, two fp32 moments a tensor."""
    from kandinsky2_tpu_torch.train.optim import Adam

    cfg = yaml.safe_load(yaml.safe_dump(YAML))
    cfg["model_config"]["model"]["hparams"].update(xf_width=32, xf_layers=2, xf_heads=2)
    cfg.update(num_epochs=1, save_path=str(tmp_path / "ckpt"),
               optim_params={"name": "optax.adamw", "params": {"learning_rate": 1e-4}})
    cfg["data"]["train"]["df_path"] = _pictures(tmp_path, 2, 15)
    before = {n: p.detach().clone() for n, p in tcli.build_prior(cfg, "cpu")
              .named_parameters()}
    state = tcli.run(cfg, device="cpu")
    assert state.step == 2 and isinstance(state.optimizer, Adam)
    for name, p in state.model.named_parameters():
        s = state.optimizer.state[p]
        assert s["step"] == 2 and s["mu"].dtype == s["nu"].dtype == torch.float32
        assert not torch.equal(p.detach(), before[name]), name


def test_prior_cli_without_bpe_path_departs_from_jax(tmp_path):
    """A departure: with no ``bpe_path`` the JAX CLI hands its prior-mode
    dataset no tokenizer (``train_prior.py:42``), which fails on the first
    sample; the port's CLI takes the stand-in BPE tokenizer and loads."""
    from kandinsky2_tpu.train import data as jdata

    csv_path = _pictures(tmp_path, 2, 14)
    with pytest.raises(AttributeError):
        jdata.TextImageDataset(csv_path=csv_path, tokenizer=None, mode="prior")[0]
    cfg = yaml.safe_load(yaml.safe_dump(YAML))
    cfg["data"]["train"]["df_path"] = csv_path
    batch = next(iter(tcli.make_loader(cfg)))
    assert batch["tokens"].shape == (1, 77) and batch["mask"].dtype == bool


@pytest.mark.parametrize("change", [
    {"optim_params": {"name": "optax.lion", "params": {"learning_rate": 1e-4}}},
    {"optim_params": {"name": "optax.adamw",
                      "params": {"learning_rate": 1e-4, "mask": {"kernel": True}}}},
])
def test_run_rejects_what_the_port_lacks(change):
    """The decoder CLI's refusals, before anything is built."""
    with pytest.raises(NotImplementedError):
        tcli.run(dict(YAML, **change), device="cpu")


def test_chip_smoke_carries_config_prior_yaml():
    """The card's machine has no PyYAML: ``chip_smoke.py`` holds the YAML as
    a dict, which must be the file's."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.PRIOR_YAML == YAML
