"""The PyTorch package's training path against the JAX package's, on the CPU
in fp32, at a tiny size of the llama2_7b preset (2 layers, hidden 256, 4
heads over 2 KV heads, vocab 512, seq 64). Weights are carried over by
``interop.params_from_jax``; inputs are the same numpy arrays.

- losses (fused and unfused) and every gradient against ``jax.grad``
  through the JAX model: atol 2e-4 / rtol 1e-3 (the model-twin tolerance);
- schedule, clipping and AdamW against ``optim.make_optimizer``'s optax
  chain on the same gradients for 3 updates: atol 1e-6;
- the loader's batches against the JAX ``HostDataLoader``: exactly;
- ``Trainer.fit`` for 3 steps against the JAX ``make_train_step`` over the
  same batches: loss rtol 1e-4 per step, params atol 2e-4 / rtol 1e-3;
- ``train_cli`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_train_tpu import config as jconfig
from pytorch_distributed_train_tpu import losses as jlosses
from pytorch_distributed_train_tpu.data.datasets import (
    build_dataset as j_build_dataset,
)
from pytorch_distributed_train_tpu.data.pipeline import (
    HostDataLoader as JHostDataLoader,
)
from pytorch_distributed_train_tpu.models.registry import (
    build_model as j_build_model,
)
from pytorch_distributed_train_tpu.optim import (
    make_optimizer as j_make_optimizer,
)
from pytorch_distributed_train_tpu.steps import (
    make_train_step as j_make_train_step,
)
from pytorch_distributed_train_tpu.train_state import (
    TrainState as JTrainState,
)
from pytorch_distributed_train_tpu_torch import config as tconfig
from pytorch_distributed_train_tpu_torch import losses as tlosses
from pytorch_distributed_train_tpu_torch import train_cli
from pytorch_distributed_train_tpu_torch.data.datasets import build_dataset
from pytorch_distributed_train_tpu_torch.data.pipeline import HostDataLoader
from pytorch_distributed_train_tpu_torch.interop import params_from_jax
from pytorch_distributed_train_tpu_torch.models.registry import build_model
from pytorch_distributed_train_tpu_torch.optim import make_optimizer
from pytorch_distributed_train_tpu_torch.trainer import Trainer

ATOL, RTOL = 2e-4, 1e-3
TINY = ["model.num_layers=2", "model.hidden_size=256", "model.num_heads=4",
        "model.num_kv_heads=2", "model.mlp_dim=512", "model.vocab_size=512",
        "model.max_seq_len=64", "data.seq_len=64", "data.batch_size=2",
        "data.synthetic_size=8", "precision.compute_dtype=float32",
        "optim.warmup_steps=1", "total_steps=10", "obs.log_every_steps=1"]


def _cfgs(*extra):
    jc = jconfig.get_preset("llama2_7b")
    tc = tconfig.get_preset("llama2_7b")
    for c in (jc, tc):
        c.apply_overrides(TINY + list(extra))
    jc.model.attention_impl = "xla"
    return jc, tc


@pytest.fixture(scope="module")
def jparams():
    jc, _ = _cfgs()
    params = j_build_model(jc.model, jc.precision).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]
    return jax.tree.map(np.asarray, params)


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, 512, (2, 64)).astype(
        np.int32)


@pytest.mark.parametrize("fused,impl", [(True, "xla"), (False, "xla"),
                                        (True, "pallas")])
def test_loss_and_every_gradient_match_jax(jparams, fused, impl):
    loss_name = "fused_causal_lm_xent" if fused else "causal_lm_xent"
    jc, tc = _cfgs(f"model.fused_lm_loss={fused}", f"loss={loss_name}")
    tc.model.attention_impl = impl
    ids = _ids()
    jmodel = j_build_model(jc.model, jc.precision)
    jloss_fn = jlosses.get_loss_fn(loss_name)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(ids), train=True)
        return jloss_fn(out, {"input_ids": jnp.asarray(ids)})[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    ref_grads = params_from_jax(jax.tree.map(np.asarray, ref_grads))

    model = build_model(tc.model, tc.precision, params_from_jax(jparams),
                        device="cpu", trainable=True)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    out = model(batch["input_ids"])
    assert isinstance(out, dict) == fused
    loss, aux = tlosses.get_loss_fn(loss_name)(out, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=ATOL,
                               rtol=RTOL)
    assert aux["perplexity"].item() == pytest.approx(
        float(np.exp(float(ref_loss))), rel=1e-3)
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref_grads)
    for name, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_schedule_clip_and_adamw_match_optax(jparams):
    jc, tc = _cfgs()
    total = 10
    tx, sched = j_make_optimizer(jc.optim, total_steps=total)
    model = build_model(tc.model, tc.precision, params_from_jax(jparams),
                        device="cpu", trainable=True)
    ttx, tsched = make_optimizer(tc.optim, model.named_parameters(), total)
    for count in range(total + 2):
        assert tsched(count) == pytest.approx(float(sched(count)), rel=1e-6,
                                              abs=1e-12)
    assert tsched(0) == 0.0  # warmup: the first update runs at lr 0
    no_decay = {id(p) for p in ttx.torch_opt.param_groups[1]["params"]}
    assert {n for n, p in model.named_parameters() if id(p) in no_decay} == {
        n for n in dict(model.named_parameters()) if n.endswith(".scale")}

    rng = np.random.default_rng(5)
    jp = jax.tree.map(jnp.asarray, jparams)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    named = dict(model.named_parameters())
    # ||g|| about 0.1, 12 and 1.2: clipping (max 1.0) off, on, on
    for step, scale in enumerate((1e-4, 1e-2, 1e-3)):
        g = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(
                np.float32), jparams)
        updates, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, t in params_from_jax(g).items():
            named[name].grad = t
        gnorm = ttx.step(step)
        assert gnorm.item() == pytest.approx(
            float(optax.global_norm(g)), rel=1e-5)
        ref = params_from_jax(jax.tree.map(np.asarray, jp))
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} after update {step}")
        if step == 0:  # lr 0: nothing moved
            base = params_from_jax(jparams)
            assert all(torch.equal(p.detach(), base[n])
                       for n, p in named.items())


@pytest.mark.parametrize("size", [8, 9])
def test_loader_batches_match_jax(size):
    jc, tc = _cfgs(f"data.synthetic_size={size}")
    jl = JHostDataLoader(j_build_dataset(jc.data, jc.model, train=True),
                         jc.data, train=True, num_hosts=1, host_id=0)
    tl = HostDataLoader(build_dataset(tc.data, tc.model, train=True),
                        tc.data, device="cpu")
    assert tl.steps_per_epoch == jl.steps_per_epoch == size // 2
    for epoch in (0, 1):
        ref = [b["input_ids"] for b in jl.epoch(epoch)]
        host = [b["input_ids"] for b in tl.host_batches(epoch)]
        dev = [b["input_ids"] for b in tl.epoch(epoch)]
        assert len(ref) == len(host) == len(dev) == size // 2
        for r, h, d in zip(ref, host, dev):
            np.testing.assert_array_equal(h, r)
            assert d.dtype == torch.long
            np.testing.assert_array_equal(d.numpy(), r)


def test_trainer_fit_matches_jax_train_step(jparams, capsys):
    jc, tc = _cfgs()
    trainer = Trainer(tc, device="cpu", params=params_from_jax(jparams))
    state = trainer.fit(3)
    assert state.step == 3
    losses = [r["loss"] for r in trainer.history]
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 3 and "[summary] steps=3" in out

    model = j_build_model(jc.model, jc.precision)
    tx, _ = j_make_optimizer(jc.optim, trainer.total_steps,
                             trainer.steps_per_epoch)
    jstate = JTrainState.create(params=jax.tree.map(jnp.asarray, jparams),
                                tx=tx)
    step = jax.jit(j_make_train_step(
        model, jlosses.get_loss_fn(jc.loss), tx))
    loader = JHostDataLoader(j_build_dataset(jc.data, jc.model, train=True),
                             jc.data, train=True, num_hosts=1, host_id=0)
    ref_losses = []
    for batch, _ in zip(loader.epoch(0), range(3)):
        jstate, metrics = step(jstate, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(0))
        ref_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def _cli_args(*extra):
    argv = ["--device", "cpu"]
    for s in TINY + list(extra):
        argv += ["--set", s]
    return argv


def test_train_cli_runs_on_cpu_and_refuses_what_is_not_ported(capsys):
    assert train_cli.main(_cli_args() + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] step=2" in out and "[summary] steps=2" in out
    assert train_cli.main(["--list-configs"]) == 0
    assert "llama2_7b" in capsys.readouterr().out
    assert train_cli.main(_cli_args() + ["--print-config"]) == 0
    assert '"num_layers": 2' in capsys.readouterr().out
    for argv, msg in [
        (_cli_args() + ["--resume", "none"], "not ported"),
        (_cli_args("optim.name=lamb"), "optim.name"),
        (_cli_args("optim.ema_decay=0.9"), "optim.ema_decay"),
        (_cli_args("checkpoint.save_every_steps=5"), "checkpointing"),
        (_cli_args("sentinel.enabled=true"), "sentinel"),
        (_cli_args("model.remat_policy=dots"), "remat_policy"),
    ]:
        assert train_cli.main(argv) == 2, argv
        assert msg in capsys.readouterr().err


def test_unported_config_values_are_refused():
    _, tc = _cfgs()
    tc2 = dataclasses.replace(tc, precision=dataclasses.replace(
        tc.precision, loss_scale="dynamic"))
    with pytest.raises(NotImplementedError, match="DynamicScale"):
        Trainer(tc2, device="cpu")
    _, tc3 = _cfgs("data.dataset=text_lm")
    with pytest.raises(NotImplementedError, match="synthetic_lm"):
        Trainer(tc3, device="cpu")
