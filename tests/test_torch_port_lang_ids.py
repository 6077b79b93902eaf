"""Language ids in the port (``embed_lang_id``: the multilingual configs'
hypernets, e.g. mistral7b_multilingual_lw0.5_long) held against the JAX
package on the CPU: the language-id token on the inference and training
routes (bf16 and f32), flax ``nn.Embed``'s index rules, the training
route's gradients including ``lang_embedding``'s, the conversion of
``lang_embedding`` both ways, train and identity steps on a three-language
data directory against JAX's Trainer, and both transfer CLIs at two
``--lang-index`` values. Also the prior-biased config without inter-token
attention (the Mistral configs' case), which reads no priors. The same
numpy-seeded inputs and parameters go through both sides."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxConfig
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.convert import flax_paths, flax_to_torch, torch_to_flax

from test_torch_port_hypernet import CONFIG, _inputs

LANG = dict(CONFIG, embed_lang_id=True, n_langs=3)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LANG_PATH = "encoder/lang_embedding/embedding"


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(jmodel, sf, src, seed=1):
    """Init the Flax tree (a language id is an integer array to nn.Embed;
    shape (1,) suits a one-row table too), then refill every leaf from a
    numpy seed (f32 leaves)."""
    p = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(sf[:4]), jnp.zeros(4), jnp.asarray(src),
                    jnp.asarray([0]))
    flat = traverse_util.flatten_dict(p["params"], sep="/")
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("kernel"):
            x = rng.normal(size=v.shape) / np.sqrt(v.shape[0])
        elif k.endswith("scale") or k.endswith("/w"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            x = 0.05 * rng.normal(size=v.shape)
        flat[k] = np.asarray(x, np.float32)
    return flat


def _pair(cfg, dtype_name="float32"):
    """(JAX model, its flat params, the port model holding them)."""
    jdt, tdt = DTYPES[dtype_name]
    sf, src = _inputs()
    jmodel = JaxHypernet(JaxConfig(**cfg), dtype=jdt)
    flat = _params(jmodel, sf, src)
    model = Hypernet(HypernetConfig(**cfg), dtype=tdt)
    model.load_state_dict(flax_to_torch(flat))
    return jmodel, flat, model


def _run_both(cfg, dtype_name, lang_index, inference=True, priors=None):
    jmodel, flat, model = _pair(cfg, dtype_name)
    sf, src = _inputs()
    jpr = None if priors is None else jnp.asarray(priors)
    tpr = None if priors is None else torch.from_numpy(priors)
    refs = jmodel.apply({"params": traverse_util.unflatten_dict(flat, sep="/")},
                        jnp.asarray(sf), jpr, jnp.asarray(src), jnp.asarray(lang_index),
                        inference=inference)
    with torch.no_grad():
        gots = model(torch.from_numpy(sf).long(), tpr, torch.from_numpy(src),
                     torch.tensor(lang_index), inference=inference)
    return gots, refs


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["inference", "training"])
def test_lang_id_hypernet_matches_jax(route, dtype_name):
    """The language-id token appended after the surface form (L 7 + 1:
    layer 0 through kernel 1's plain version on the inference route, the
    tier-4 core on the training route; the CLS-only layer through kernel
    2's) at lang_index 2 of 3. f32: max abs 1e-5 (outputs of magnitude ~4);
    bf16: max abs <= 2% of the output scale and mean <= 0.3% (XLA rounds
    every bf16 op, the port's fused steps round once), the bias within 0.03."""
    gots, refs = _run_both(LANG, dtype_name, 2, inference=route == "inference")
    for name, got, ref in zip(("in", "out", "bias"), gots, refs):
        if ref is None:
            assert got is None, name
            continue
        got, ref = _f32(got), _f32(ref)
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        err = np.abs(got - ref)
        if dtype_name == "float32":
            assert err.max() <= 1e-5, (name, err.max())
        elif name == "bias":
            assert err.max() <= 0.03, err.max()
        else:
            scale = np.abs(ref).max()
            assert err.max() <= 0.02 * scale, (name, err.max(), scale)
            assert err.mean() <= 0.003 * scale, (name, err.mean(), scale)


@pytest.mark.parametrize("n_langs,index", [(3, 0), (3, -1), (3, 3), (1, [5])])
def test_lang_index_follows_flax_embed(n_langs, index):
    """flax nn.Embed's rules, f32: a row by index, a negative index counted
    from the end, an index past the end a row of NaN (``jnp.take``'s fill),
    and a one-row table its row for any index of shape (1,); the outputs
    equal JAX's within 1e-5 (NaN where JAX has NaN)."""
    gots, refs = _run_both(dict(LANG, n_langs=n_langs), "float32", index)
    nan = n_langs > 1 and not -n_langs <= index < n_langs
    for got, ref in zip(gots, refs):
        if ref is None:
            continue
        got, ref = _f32(got), _f32(ref)
        assert np.isnan(ref).all() == nan and np.array_equal(np.isnan(got), np.isnan(ref))
        live = ~np.isnan(ref)
        assert np.abs(got[live] - ref[live]).max(initial=0.0) <= 1e-5


def test_one_language_table_refuses_a_scalar_index_as_jax_does():
    """flax broadcasts a one-row table to the index's shape plus H, which a
    scalar index cannot take: both sides raise."""
    cfg = dict(LANG, n_langs=1)
    jmodel, flat, model = _pair(cfg)
    sf, src = _inputs()
    with pytest.raises(ValueError, match="broadcast"):
        jmodel.apply({"params": traverse_util.unflatten_dict(flat, sep="/")}, jnp.asarray(sf),
                     None, jnp.asarray(src), jnp.asarray(0))
    with pytest.raises(RuntimeError, match="expand"):
        model(torch.from_numpy(sf).long(), None, torch.from_numpy(src), 0)


def test_lang_index_changes_every_row():
    """Two language ids give two different predictions for every row."""
    _, _, model = _pair(LANG)
    sf, src = _inputs()
    with torch.no_grad():
        a, b = (model(torch.from_numpy(sf).long(), None, torch.from_numpy(src), i)[0]
                for i in (0, 1))
    assert (a - b).abs().amax(-1).min() > 0


def test_lang_id_config_reads_lang_index():
    _, _, model = _pair(LANG)
    sf, src = _inputs()
    with pytest.raises(ValueError, match="lang_index"):
        model(torch.from_numpy(sf).long(), None, torch.from_numpy(src), None)


def test_lang_id_training_route_gradients_match_jax():
    """The training route's outputs within 1e-5 of their largest, its loss
    (summed in f64 on both sides) within 1e-5 of its terms' summed
    magnitudes, and every parameter gradient with the
    language-id token, f32, within 1e-5 of each leaf's largest gradient (or
    of 1% of the model's largest for leaves whose exact gradient is 0);
    ``lang_embedding``'s gradient is nonzero on the row in use and zero on
    the others."""
    jmodel, flat, model = _pair(LANG)
    sf, src = _inputs()
    rng = np.random.default_rng(3)
    w_in = rng.normal(size=(len(sf), LANG["n_embd"])).astype(np.float32)
    w_b = rng.normal(size=len(sf)).astype(np.float32)

    def jloss(params):
        e, _, b = jmodel.apply({"params": params}, jnp.asarray(sf), None, jnp.asarray(src),
                               jnp.asarray(1), deterministic=True, inference=False)
        return (e * w_in).sum() + (b * w_b).sum()

    jparams = traverse_util.unflatten_dict(flat, sep="/")
    _, jgrads = jax.value_and_grad(jloss)(jparams)
    jgrads = traverse_util.flatten_dict(jgrads, sep="/")
    je, _, jb = jmodel.apply({"params": jparams}, jnp.asarray(sf), None, jnp.asarray(src),
                             jnp.asarray(1), deterministic=True, inference=False)
    e, _, b = model(torch.from_numpy(sf).long(), None, torch.from_numpy(src), torch.tensor(1),
                    deterministic=True, inference=False)
    got = (e * torch.from_numpy(w_in)).sum() + (b * torch.from_numpy(w_b)).sum()
    got.backward()
    # the loss sums len(sf) * (n_embd + 1) products of random sign that
    # cancel to a small share of their magnitudes: hold the outputs element
    # by element, and the loss summed in f64 on both sides against the
    # summed magnitudes of its terms
    for out, want_out in ((e, je), (b, jb)):
        want_out = _f32(want_out)
        assert np.abs(_f32(out) - want_out).max() <= 1e-5 * np.abs(want_out).max()
    terms = [np.concatenate([(_f32(x).astype(np.float64) * w_in).ravel(),
                             (_f32(y).astype(np.float64) * w_b).ravel()])
             for x, y in ((e, b), (je, jb))]
    assert abs(terms[0].sum() - terms[1].sum()) <= 1e-5 * np.abs(terms[1]).sum()
    floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jgrads.values())
    params = dict(model.named_parameters())
    for name, (path, transpose) in flax_paths(model).items():
        g = params[name].grad
        g = _f32(g.t() if transpose else g)
        want_g = _f32(jgrads["/".join(path)])
        scale = max(float(np.abs(want_g).max()), floor)
        assert np.abs(g - want_g).max() <= 1e-5 * scale, (name, np.abs(g - want_g).max())
    lang = _f32(params["encoder.lang_embedding.weight"].grad)
    assert np.abs(lang[1]).max() > 0 and not lang[[0, 2]].any()


def test_lang_embedding_converts_both_ways():
    """Flax -> torch puts ``encoder/lang_embedding/embedding`` (n_langs, H)
    on ``encoder.lang_embedding.weight``; torch -> Flax (the params.npz a
    checkpoint writes) gives the Flax tree back, every leaf bitwise."""
    _, flat, model = _pair(LANG)
    sd = model.state_dict()
    assert tuple(sd["encoder.lang_embedding.weight"].shape) == (3, LANG["hidden_size"])
    np.testing.assert_array_equal(sd["encoder.lang_embedding.weight"].numpy(),
                                  np.asarray(flat[LANG_PATH]))
    back = torch_to_flax(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("with_priors", [False, True])
def test_prior_bias_without_inter_token_attention_reads_no_priors(with_priors):
    """``inter_token_attention_bias_by_priors`` without
    ``add_inter_token_attention`` (the Mistral configs): the JAX module
    reads the priors only for the inter-token exchange, so the config runs
    without them, and with them gives the same outputs; f32 within 1e-5."""
    cfg = dict(LANG, inter_token_attention_bias_by_priors=True)
    priors = np.random.default_rng(5).normal(size=48).astype(np.float32) if with_priors else None
    gots, refs = _run_both(cfg, "float32", 0, priors=priors)
    for got, ref in zip(gots, refs):
        if ref is not None:
            assert np.abs(_f32(got) - _f32(ref)).max() <= 1e-5


# -------------------------------------------------- train and identity steps
def test_train_and_identity_steps_with_lang_ids_match_jax(tmp_path, corpus, gpt2_like_json):
    """Batches of a three-language data directory (one language a batch,
    lang_index from the Collator; the identity batch at language 0) through
    an identity step and two train steps of JAX's Trainer and the port's
    from the same parameters, f32: losses within 1e-5 relative, the last
    step's hypernet gradients within 1e-4 of each leaf's largest (or of 1%
    of the model's largest), ``lang_embedding``'s nonzero on the batch's
    language row only."""
    from test_torch_port_training import HN, _torch_grads_by_path

    from zett_tpu.models.backbones.gpt2 import GPT2Config as JaxGPT2Config
    from zett_tpu.models.backbones.gpt2 import GPT2LMHeadModel as JaxGPT2
    from zett_tpu.models.backbones.loader import invert_gpt2
    from zett_tpu.training import Trainer as JaxTrainer
    from zett_tpu.training import TrainingConfig as JaxTrainingConfig
    from zett_tpu.training.state import TrainState as JaxTrainState
    from zett_tpu_torch.data import Collator, DataConfig, TrainDataset
    from zett_tpu_torch.models.backbones.gpt2 import GPT2Config
    from zett_tpu_torch.tokenization.core import Tokenizer
    from zett_tpu_torch.training import Trainer, TrainingConfig

    langs = ["en", "de", "fr"]
    texts = [t for t in corpus if t.strip()]
    for i, lang in enumerate(langs):
        (tmp_path / f"{lang}.txt").write_text("\n".join(texts[i::3]) + "\n")
    reference = Tokenizer.from_json(gpt2_like_json)
    data_cfg = DataConfig(block_size=16, hn_surface_maxlen=4, n_token_subsample=None,
                          pad_to_multiple_of=64, tokenizer_sample_mean=256,
                          tokenizer_sample_std=0, tokenizer_sample_min=256,
                          tokenizer_sample_max=384, langs=langs)
    dataset = TrainDataset(langs=langs, batch_size=2, block_size=16,
                           train_directory=str(tmp_path), seed=3,
                           eos_token=reference.all_special_tokens[0])
    collator = Collator(reference=reference, hn_tokenizer=reference.copy(),
                        data_config=data_cfg, batch_size=2,
                        initial_texts=dataset.get_texts_in_each_language(16), seed=3)
    id_collator = Collator(reference=reference, hn_tokenizer=reference.copy(),
                           data_config=dataclasses.replace(data_cfg, do_tokenizer_sampling=False,
                                                           n_token_subsample=128),
                           batch_size=2, fixed_tokenizer=reference.copy(), lang_code=langs[0],
                           seed=3)
    batches, seen = [], set()
    for item in dataset:
        batch = collator([item])
        if int(batch["lang_index"]) not in seen:
            seen.add(int(batch["lang_index"]))
            batches.append(batch)
        if len(batches) == 2:
            break
    assert len(seen) == 2 and seen <= {0, 1, 2}
    ident = id_collator(None, for_identity_step=True)
    assert int(ident["lang_index"]) == 0

    vocab = len(reference)
    bb_cfg = JaxGPT2Config(vocab_size=vocab, n_positions=32, n_embd=64, n_layer=2, n_head=2)
    bb_params = JaxGPT2(bb_cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    hn = dict(HN, embed_lang_id=True, n_langs=3)
    kw = dict(steps=6, learning_rate=1e-3, warmup_steps=1, lexical_loss_weight=0.5,
              lexical_loss_kind="huber", max_grad_norm=1.0, identity_steps=1,
              logging_steps=10, save_steps=0, eval_steps=0, dtype="float32")
    captured = []
    orig = JaxTrainState.apply_gradients

    def capture(self, *, grads, **kwargs):
        jax.debug.callback(captured.append, grads)
        return orig(self, grads=grads, **kwargs)

    JaxTrainState.apply_gradients = capture
    try:
        jtr = JaxTrainer(hn_config=JaxConfig(**hn), backbone_config=bb_cfg,
                         backbone_params=bb_params, model_type="gpt2",
                         train_config=JaxTrainingConfig(**kw), vocab_batch_size=64)
        hn_params = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in
                     traverse_util.flatten_dict(jtr.state.params["hypernet"], sep="/").items()}
        assert hn_params[LANG_PATH].shape == (3, HN["hidden_size"])
        sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, bb_params), bb_cfg)
        ttr = Trainer(hn_config=HypernetConfig(**hn),
                      backbone_config=GPT2Config(vocab_size=vocab, n_positions=32, n_embd=64,
                                                 n_layer=2, n_head=2),
                      backbone_state={k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                      model_type="gpt2", train_config=TrainingConfig(**kw), device="cpu",
                      hn_params=hn_params)
        jtr.state, jm = jtr.identity_train_step(jtr.state, jtr._device_batch(ident))
        tm = ttr.identity_train_step(ident)
        assert abs(tm["identity_loss"] - float(jm["identity_loss"])) <= \
            1e-5 * abs(float(jm["identity_loss"]))
        for batch in batches:
            jtr.state, jm = jtr.train_step(jtr.state, jtr._device_batch(batch))
            tm = ttr.train_step(batch)
            for key in ("loss", "lexical_loss"):
                assert abs(tm[key] - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    finally:
        JaxTrainState.apply_gradients = orig
    jgrads = traverse_util.flatten_dict(captured[-1])
    tgrads = _torch_grads_by_path(ttr)
    floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for p, g in jgrads.items()
                       if p[0] == "hypernet")
    for path, g in jgrads.items():
        if path[0] != "hypernet":
            continue
        scale = max(float(np.abs(_f32(g)).max()), floor)
        err = np.abs(_f32(tgrads[path]) - _f32(g)).max()
        assert err <= 1e-4 * scale, (path, err)
    lang = _f32(tgrads[("hypernet",) + tuple(LANG_PATH.split("/"))])
    used = int(batches[-1]["lang_index"])
    assert np.abs(lang[used]).max() > 0
    assert not np.delete(lang, used, axis=0).any()


# ------------------------------------------------------------- transfer CLI
def test_transfer_cli_at_two_lang_indices_matches_jax(tmp_path):
    """Both transfer CLIs on one multilingual checkpoint (3 languages) and
    one HF GPT-2 directory at --lang-index 0 and 2: the spliced table and
    bias.npy within 1e-5 of the JAX CLI's (f32 hypernet, sums in another
    order), and the two indices give two different tables."""
    import orbax.checkpoint as ocp
    from safetensors.numpy import load_file

    from test_torch_port_transfer import TOK, _config, _write_gpt2_dir
    from zett_tpu.transfer.__main__ import main as jax_main
    from zett_tpu_torch.tokenization import Tokenizer
    from zett_tpu_torch.transfer.__main__ import main as port_main

    vocab = len(Tokenizer.from_file(TOK.format("gpt2_raw")))
    model_dir = str(tmp_path / "gpt2")
    sd = _write_gpt2_dir(model_dir, vocab)
    cfg = dict(_config(vocab), embed_lang_id=True, n_langs=3)
    src = sd["transformer.wte.weight"].numpy()
    flat = _params(JaxHypernet(JaxConfig(**cfg)), np.ones((4, 7), np.int32), src)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    with open(ckpt / "hn_config.json", "w") as f:
        json.dump(JaxConfig(**cfg).to_dict(), f)
    np.savez(ckpt / "params.npz", **flat)
    Tokenizer.from_file(TOK.format("gpt2_raw")).save(str(ckpt / "tokenizer.json"))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(ckpt / "state"), traverse_util.unflatten_dict(flat, sep="/"))
    ckptr.wait_until_finished()

    common = ["--checkpoint", str(ckpt), "--model", model_dir,
              "--target-tokenizer", TOK.format("de_raw"), "--batch-size", "4096"]
    tables = {}
    for index in (0, 2):
        jax_out, port_out = str(tmp_path / f"jax_{index}"), str(tmp_path / f"port_{index}")
        jax_main(common + ["--output", jax_out, "--lang-index", str(index)])
        port_main(common + ["--output", port_out, "--lang-index", str(index), "--device", "cpu"])
        ref = load_file(os.path.join(jax_out, "model.safetensors"))["transformer.wte.weight"]
        got = load_file(os.path.join(port_out, "model.safetensors"))["transformer.wte.weight"]
        assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5, index
        bias_ref = np.load(os.path.join(jax_out, "bias.npy"))
        bias_got = np.load(os.path.join(port_out, "bias.npy"))
        assert np.abs(bias_got - bias_ref).max() <= 1e-5, index
        tables[index] = got
    assert np.abs(tables[0] - tables[2]).max() > 1e-3
