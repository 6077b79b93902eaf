"""The port's multi-GPU layer (zett_tpu_torch/parallel) on the CPU: two
ranks under gloo, spawned once (``torch_parallel_worker.py``: neither JAX
nor the JAX package in them), held against one process running the same
code and against the JAX Trainer on a 4 x 2 mesh.

Tolerances: 2 ranks against 1 rank, losses within 1e-5 relative and
parameters within 1e-5 of each leaf's scale, a leaf's scale being at least
the summed learning rates (how far AdamW moves an element whatever its
gradient: a leaf that starts at 0 is that small), plus, element by
element, what AdamW carries of the measured gradient differences where
the gradients were measured (GPT-2 at dropout 0; the frozen bf16
backbone's gradients are summed over the ranks in bf16 and enter the
clip's norm); the histogram and the preemption step exactly. At dropout 0 the ranks
against JAX's mesh run within ``test_train_and_identity_steps_match_jax``'s
tolerances."""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

import torch_parallel_worker as W
from test_torch_port_training import _adam_carried_differences, _close, _f32
from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.models.backbones.gpt2 import GPT2Config as JaxGPT2Config
from zett_tpu.models.backbones.gpt2 import GPT2LMHeadModel as JaxGPT2
from zett_tpu.models.backbones.loader import invert_gpt2
from zett_tpu.parallel import make_mesh
from zett_tpu.parallel.multihost import batch_seed_for_step as jax_batch_seed
from zett_tpu.training import Trainer as JaxTrainer
from zett_tpu.training import TrainingConfig as JaxTrainingConfig
from zett_tpu.training.state import TrainState as JaxTrainState
from zett_tpu_torch.parallel import batch_seed_for_step, local_batch, process_slice

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
RANK_TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_cli_inputs(work, corpus, gpt2_like_json):
    """A tiny HF GPT-2 directory and the CLI test's config
    (tests/test_torch_port_training.py), batch and vocab rows even."""
    from safetensors.numpy import save_file

    from test_torch_port_training import _cli_config
    from zett_tpu.tokenization import Tokenizer as JaxTokenizer

    model_dir = os.path.join(work, "gpt2_hf")
    os.makedirs(model_dir)
    tok = JaxTokenizer.from_json(gpt2_like_json)
    cfg = JaxGPT2Config(vocab_size=len(tok), n_positions=64, n_embd=64, n_layer=1, n_head=1)
    params = JaxGPT2(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, params), cfg)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              os.path.join(model_dir, "model.safetensors"))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": len(tok), "n_positions": 64,
                   "n_embd": 64, "n_layer": 1, "n_head": 1, "layer_norm_epsilon": 1e-5,
                   "tie_word_embeddings": True}, f)
    tok.save(os.path.join(model_dir, "tokenizer.json"))
    with open(os.path.join(work, "cli.json"), "w") as f:
        json.dump(_cli_config(model_dir, "", corpus), f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus, gpt2_like_json):
    """(the two ranks' results, one process's results, the work dir, the
    JAX run). The JAX Trainer on make_mesh(4, 2) gives the parameters the
    ranks start from (``inputs.npz``); while the ranks run, this process
    runs the one-process references and then JAX's steps at dropout 0 (an
    identity step and two train steps on the worker's batches), keeping
    JAX's losses, gradients and parameters. The one-process references run
    in a process of their own, beside the ranks."""
    work = str(tmp_path_factory.mktemp("parallel"))
    bb_cfg = JaxGPT2Config(**W.GPT2)
    bb_params = JaxGPT2(bb_cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    mesh = make_mesh(n_data=4, n_model=2)
    jtr = JaxTrainer(hn_config=JaxHnConfig(**W.HN), backbone_config=bb_cfg,
                     backbone_params=bb_params, model_type="gpt2",
                     train_config=JaxTrainingConfig(**W.TRAIN), vocab_batch_size=W.V_BATCH,
                     mesh=mesh)
    inputs = {f"hn/{k}": np.asarray(jnp.asarray(v, jnp.float32)) for k, v in
              traverse_util.flatten_dict(jtr.state.params["hypernet"], sep="/").items()}
    sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, bb_params), bb_cfg)
    inputs.update({f"bb/{k}": np.array(v) for k, v in sd.items()})
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    _write_cli_inputs(work, corpus, gpt2_like_json)
    one = os.path.join(work, "one")
    os.makedirs(one)
    for name in ("inputs.npz", "cli.json"):
        shutil.copy(os.path.join(work, name), one)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(WORKER)),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(port), path],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, world, path in ((0, 2, work), (1, 2, work), (0, 1, one))]
    try:
        captured, losses = [], []
        orig = JaxTrainState.apply_gradients

        def capture(self, *, grads, **kw):
            jax.debug.callback(captured.append, grads)
            return orig(self, grads=grads, **kw)

        JaxTrainState.apply_gradients = capture
        try:
            for kind, seed in (("identity", 10), ("train", 11), ("train", 12)):
                with mesh:
                    batch = jtr._device_batch(W.make_batch(seed))
                    step = jtr.identity_train_step if kind == "identity" else jtr.train_step
                    jtr.state, m = step(jtr.state, batch)
                losses.append(float(m["identity_loss" if kind == "identity" else "loss"]))
        finally:
            JaxTrainState.apply_gradients = orig
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = []
    for path in (os.path.join(work, "rank0.npz"), os.path.join(work, "rank1.npz"),
                 os.path.join(one, "rank0.npz")):
        with np.load(path) as z:
            ranks.append({k: z[k] for k in z.files})
    single = ranks.pop()
    jax_run = {"losses": losses, "grads": [traverse_util.flatten_dict(g) for g in captured],
               "params": traverse_util.flatten_dict(jtr.state.params)}
    return ranks, single, work, jax_run


def _rel(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12), \
        (np.abs(got - want).max(), np.abs(want).max())


def _params_close(got, want, what, rel=1e-5, carried=None, lr_sum=0.0):
    """Each leaf within ``rel`` of max(its scale, ``lr_sum``), plus
    ``carried`` element by element."""
    for k, w in want.items():
        floor = 0.0 if carried is None else carried.get(k, 0.0)
        err = np.abs(np.asarray(got[k], np.float64) - np.asarray(w, np.float64))
        scale = max(float(np.abs(w).max()), lr_sum)
        assert (err <= rel * scale + floor).all(), (what, k, err.max(), scale)


def _step_grads(results):
    """The recorded gradients, a {path tuple: array} a step."""
    n = len({k.split("/")[0] for k in results if k.startswith("grad")})
    return [{tuple(k.split("/")): v for k, v in _sub(results, f"grad{i}/").items()}
            for i in range(n)]


def _clip_scale(grads, cfg):
    """The clip factor the trainer took for these gradients: the port's
    ``global_norm`` over the sorted paths, the frozen backbone's leaves in
    bf16 (each leaf's sum rounded to its dtype: a bf16 sum can move by an
    ulp between two runs whose gradients differ by rounding)."""
    from zett_tpu_torch.training.optimizer import global_norm

    leaves = [torch.from_numpy(np.asarray(grads[p], np.float32)).to(
        torch.bfloat16 if p[0] == "inner" else torch.float32) for p in sorted(grads)]
    return min(1.0, cfg.max_grad_norm / float(global_norm(leaves)))


def _carried(want, got, cfg):
    """Per element, what AdamW carries of the differences between two runs'
    clipped gradients, step by step, as ``_adam_carried_differences``
    bounds it, each run's gradients clipped by the factor its trainer took
    (``_clip_scale``)."""
    wg, gg = _step_grads(want), _step_grads(got)
    lrs = [float(want[f"learning_rate/{i}"]) for i in range(len(wg))]
    scales = [(_clip_scale(a, cfg), _clip_scale(b, cfg)) for a, b in zip(wg, gg)]
    out = {}
    for path in wg[0]:
        nu = diff = total = 0.0
        for t, (a, b) in enumerate(zip(wg, gg)):
            ca, cb = scales[t]
            ga = ca * np.asarray(a[path], np.float64)
            diff = diff + np.abs(cb * np.asarray(b[path], np.float64) - ga)
            nu = cfg.adam_beta2 * nu + (1 - cfg.adam_beta2) * ga * ga
            nu_hat = nu / (1 - cfg.adam_beta2 ** (t + 1))
            total = total + 3 * lrs[t] * diff / (np.sqrt(nu_hat) + cfg.adam_epsilon)
        out["/".join(path)] = total
    return out


def _lr_sum(results):
    return sum(float(v) for k, v in results.items() if k.startswith("learning_rate/"))


def _sub(results, prefix):
    return {k[len(prefix):]: v for k, v in results.items() if k.startswith(prefix)}


# --------------------------------------------------------------------- seeds
def test_batch_seed_for_step_matches_jax():
    for base in (0, 1, 42, 2**31 - 2, 10**9 + 7):
        for step in (0, 1, 2, 1000, 2**20, 10**7):
            assert batch_seed_for_step(base, step) == jax_batch_seed(base, step)


def test_split_refuses_uneven_batches():
    """A vocab or LM batch that the ranks do not divide raises, naming both
    numbers; an even one splits the LM rows and keeps the vocab rows."""
    with pytest.raises(ValueError, match="LM batch of 3 rows.*2 ranks"):
        local_batch(W.make_batch(0, b=3), 0, 2)
    with pytest.raises(ValueError, match="vocab batch of 63 rows.*2 ranks"):
        local_batch(W.make_batch(0, v=63), 1, 2)
    with pytest.raises(ValueError, match="62 rows does not split over 4 ranks"):
        process_slice(62, 0, 4)
    batch = W.make_batch(0)
    part = local_batch(batch, 1, 2)
    np.testing.assert_array_equal(part["input_ids"], batch["input_ids"][2:])
    np.testing.assert_array_equal(part["target_surface_forms"], batch["target_surface_forms"])
    assert process_slice(64, 1, 2) == slice(32, 64)


# --------------------------------------------------------------- 2 vs 1 rank
def _rank_results_agree(ranks, prefix):
    a, b = _sub(ranks[0], prefix), _sub(ranks[1], prefix)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("run", ["gpt2", "gpt2_drop", "llama", "mlm", "full", "transfer", "cli"])
def test_two_ranks_match_one(runs, run):
    """The GPT-2 trainer (dropout 0 and 0.1: the kernels' plain versions
    and the hidden dropout keyed by the global row), the tiny Llama fully
    sharded (chunked loss, dropout 0.1), a tiny XLM-R (the chunked MLM
    loss, its head on the root unit's weights, and an eval step's metrics
    summed over the ranks), passthrough tables with the
    backbone trained ("full", AdamW on shards), transfer() and the two
    CLIs under the --distributed-* flags: both ranks hold the same results,
    and they match one process's."""
    ranks, single, _, _ = runs
    _rank_results_agree(ranks, f"{run}/")
    got, want = _sub(ranks[0], f"{run}/"), _sub(single, f"{run}/")
    for k in sorted(want):
        if k.startswith(("loss", "lexical_loss", "mean_lexical", "learning_rate", "losses")):
            _rel(got[k], want[k])
    if run == "transfer":
        assert int(got["n"]) == int(want["n"])
        _rel(got["emb_in"], want["emb_in"], 1e-6)
        _rel(got["bias"], want["bias"], 1e-6)
        return
    cfg = W.TrainingConfig(**W.TRAIN)
    if run == "cli":
        from zett_tpu_torch.training.__main__ import load_configs

        with open(os.path.join(runs[2], "cli.json")) as f:
            cfg = load_configs(json.load(f))[0]
    _params_close(_sub(got, "param/"), _sub(want, "param/"), run,
                  carried=_carried(want, got, cfg), lr_sum=_lr_sum(want))
    if run == "full":
        _params_close(_sub(got, "state/"), _sub(want, "state/"), "full state")


def test_count_tokens_device_two_ranks_exact(runs):
    """The histogram summed over the ranks equals one process's, bit for
    bit."""
    ranks, single, _, _ = runs
    assert ranks[0]["counts/counts"].dtype == np.int64
    for r in ranks:
        np.testing.assert_array_equal(r["counts/counts"], single["counts/counts"])
    assert single["counts/counts"].sum() > 0


def test_refusals_under_ranks(runs):
    ranks, _, _, _ = runs
    for r in ranks:
        assert int(r["refusals/inter_token"]) == 1 and int(r["refusals/adafactor"]) == 1


# ------------------------------------------------------------- vs JAX's mesh
def test_two_ranks_match_jax_mesh(runs):
    """Dropout 0: the ranks' identity and train steps against the JAX
    Trainer on a 4 x 2 mesh: losses within 1e-5 relative, gradients within
    1e-4 of each leaf's largest (or 1% of the model's; the frozen bf16
    backbone's within 2 bf16 ulps), parameters within 1e-5 of each leaf's
    scale plus 1e-4 x the summed learning rates plus what AdamW carries of
    the gradient differences; the frozen rescalers unchanged."""
    ranks, _, work, jax_run = runs
    got = _sub(ranks[0], "gpt2/")
    for i, want in enumerate(jax_run["losses"]):
        _close(got[f"loss/{i}"], want, 1e-5, i)
    port_grads = [{tuple(k.split("/")): v for k, v in _sub(got, f"grad{i}/").items()}
                  for i in range(3)]
    jax_grads = jax_run["grads"]
    for jg, tg in zip(jax_grads, port_grads):
        assert set(jg) == set(tg), set(jg) ^ set(tg)
        floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jg.values())
        for path, g in jg.items():
            _close(tg[path], g, 1e-4 if path[0] == "hypernet" else 2 ** -7, path, floor)
    lrs = [float(got[f"learning_rate/{i}"]) for i in range(3)]
    carried = _adam_carried_differences(jax_grads, port_grads, lrs,
                                        W.TrainingConfig(**W.TRAIN))
    with np.load(os.path.join(work, "inputs.npz")) as z:
        start = {k: z[k] for k in z.files}
    for path, want in jax_run["params"].items():
        if path[0] == "inner":
            continue
        key = "/".join(path)
        mine = got[f"param/{key}"]
        if path[1] in ("scaler", "in_scaler"):
            np.testing.assert_array_equal(mine, start["hn/" + "/".join(path[1:])])
            continue
        if path[-2:] == ("key", "bias"):
            continue  # an exact gradient of 0: both sides move it by rounding noise
        err = np.abs(mine - _f32(want))
        floor = 1e-4 * sum(lrs) + carried[path]
        assert (err <= 1e-5 * np.abs(_f32(want)).max() + floor).all(), (path, err.max())


# ---------------------------------------------------------------- preemption
def test_preemption_agreed_across_ranks(runs):
    """Rank 1 alone sets its flag at step 2's boundary: both ranks stop at
    step 5's (the first agreement boundary), one preempt_step_5/ is written,
    and none other."""
    ranks, single, work, _ = runs
    for r in ranks:
        assert list(r["preempt/steps"]) == [1, 2, 3, 4, 5, 5]
        assert list(r["preempt/preempted"]) == [0, 0, 0, 0, 0, 1.0]
    run_dir = os.path.join(work, "preempt_run")
    assert sorted(os.listdir(run_dir)) == ["preempt_step_5"]
    assert os.path.isdir(os.path.join(run_dir, "preempt_step_5", "resume"))
    assert list(single["preempt/steps"]) == [1, 2, 3, 4, 5, 6, 7]


def test_two_rank_checkpoint_resumes_on_one(runs):
    """A 1-rank resume from the ranks' preempt_step_5/ ends where the
    uninterrupted 1-rank run ends (losses of steps 6 and 7 and the final
    parameters, within the 2-vs-1-rank tolerance); the ranks' full-state
    checkpoint of the fine-tuned backbone restores on one process to the
    ranks' parameters and optimizer state."""
    ranks, single, work, _ = runs
    trainer = W.gpt2_trainer(os.path.join(work, "one"), 0.1, steps=7, logging_steps=1,
                             output_dir=os.path.join(work, "resumed"))
    step = trainer.restore_checkpoint(os.path.join(work, "preempt_run", "preempt_step_5"))
    assert step == 5
    with W.capturing_grads([]) as grads:
        history = trainer.fit((W.make_batch(40 + i) for i in range(100)),
                              (W.make_batch(60 + i) for i in range(100)), resume_step=5)
    assert [h["step"] for h in history] == [6, 7]
    _rel([h["loss"] for h in history], single["preempt/losses"][5:], 1e-5)
    # the steps the resumed run took: 1-5 on the ranks, 6-7 here
    resumed = {k: v for k, v in _sub(ranks[0], "preempt/").items() if k.startswith("grad")}
    resumed.update({f"grad{5 + i}/{k}": v for i, g in enumerate(grads) for k, v in g.items()})
    want = _sub(single, "preempt/")
    _params_close(W.params_of(trainer, ("hypernet",)), _sub(want, "param/"), "resumed",
                  carried=_carried(want, resumed, W.TrainingConfig(**W.TRAIN)),
                  lr_sum=_lr_sum(want))

    full = W.llama_trainer(passthrough=True)
    full.restore_checkpoint(os.path.join(work, "full_ckpt"))
    got = _sub(ranks[0], "full/")
    _params_close(W.params_of(full), _sub(got, "param/"), "restored", rel=0.0)
    _params_close({k: v.detach().float().numpy() for k, v in
                   full.optimizer.state_arrays().items()}, _sub(got, "state/"), "restored",
                  rel=0.0)
