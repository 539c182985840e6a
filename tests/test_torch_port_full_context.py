"""The full-context wav2vec 2.0 encoder and the group-norm front-end of the
torch port against the JAX package.

Tiny dims (``tests/test_torch_port_pretrain.py`` W2V: conv hop 20, 2 layers
of 24 wide, 4 heads; conv positions of 16 taps in 4 groups), float32,
seeded numpy weights carried across by ``checkpoint/convert.py``, every
dropout and layerdrop off; the pre-training draws (negatives, Gumbel
uniforms) planted at the JAX draw sites as there.

- ``fp32_group_norm`` against JAX ``Fp32GroupNorm`` and against float64,
  forward and gradient; ``ConvFeatureExtractor`` in both modes;
  ``ConvPositionalEmbedding`` at an even and an odd kernel;
- ``Wav2Vec2Model(encoder_type="full")``: ``extract_features`` (post- and
  pre-LN) and the pre-training loss with every gradient; the CAAT loss
  and every gradient over the group-norm encoder;
- checkpoints: a fairseq-style ``.pt`` imported by both packages gives
  equal outputs (full and blockwise); the port's export equals the JAX
  export key for key and value for value; ``convert_cli --encoder-type
  full`` round trip; a warm start from a group-norm ``.pt``;
- the trainer: ``run.task=pretrain model.extractor_mode=default
  run.load_pretrained_model_from=<stock-layout .pt>`` starts from the JAX
  CLI's imported weights and gives the JAX CLI's loss on its first batch;
  ``model.pos_type=conv`` is inert; the incremental encoder still refuses
  the group norm.

Tolerances: values and losses rtol 1e-5 (atol 1e-5 where values cross 0);
gradients rtol 1e-4 with an atol of 1e-6 of the largest gradient (1e-5 for
the pre-training test's, as there); checkpoints exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_port_train as caat_train
from tests.test_checkpoint_import import fairseq_style_state_dict
from tests.test_torch_port_cli import _overrides as caat_overrides
from tests.test_torch_port_cli import corpus  # noqa: F401 (a fixture)
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from tests.test_torch_port_pretrain import (
    W2V, Draws, _assert_grads_equal, make_batch, to_jax, to_torch)
from tests.test_torch_port_pretrain_cli import _argv as pretrain_argv
from tests.test_torch_port_pretrain_cli import audio_corpus  # noqa: F401
from wav2vec_s_tpu.checkpoint import torch_export as jax_export
from wav2vec_s_tpu.checkpoint import torch_import as jax_import
from wav2vec_s_tpu.models import feature_extractor as jax_fe
from wav2vec_s_tpu.models import modules as jax_modules
from wav2vec_s_tpu.models import wav2vec2 as jax_w2v2
from wav2vec_s_tpu.train import cli as jax_cli
from wav2vec_s_tpu.train import config as jax_config
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu_torch.checkpoint import convert_cli, torch_export
from wav2vec_s_tpu_torch.checkpoint import torch_import
from wav2vec_s_tpu_torch.checkpoint.convert import (
    wav2vec2_state_dict_from_jax)
from wav2vec_s_tpu_torch.checkpoint.io import CheckpointManager, load_params
from wav2vec_s_tpu_torch.checkpoint.warm_start import (
    apply_pretrained_encoder)
from wav2vec_s_tpu_torch.models import wav2vec2 as port_w2v2
from wav2vec_s_tpu_torch.models.caat import CaatConfig, W2V2CaatModel
from wav2vec_s_tpu_torch.models.feature_extractor import ConvFeatureExtractor
from wav2vec_s_tpu_torch.models.modules import fp32_group_norm
from wav2vec_s_tpu_torch.train import cli
from wav2vec_s_tpu_torch.train.recipes import make_pretrain_loss_fn

torch.set_num_threads(1)

FULL = dataclasses.replace(W2V, extractor_mode="default", conv_pos=16,
                           conv_pos_groups=4)
FULL_PRELN = dataclasses.replace(FULL, layer_norm_first=True)
S = 2400


def _seeded(shapes, seed):
    """The tree of ``shapes`` filled as ``test_torch_port_import.jax_caat``
    fills it."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return n * float(np.prod(leaf.shape[:-1])) ** -0.5
        scale = getattr(path[-1], "key", None) == "scale"
        return (1.0 if scale else 0.0) + 0.2 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_full(cfg=FULL, encoder_type="full", seed=3):
    """(flax pre-training model, numpy params) on ``encoder_type``."""
    model = jax_w2v2.Wav2Vec2Model(cfg, encoder_type=encoder_type)
    shapes = jax.eval_shape(lambda: model.init(
        {n: jax.random.PRNGKey(0) for n in
         ("params", "dropout", "gumbel", "negatives", "layerdrop")},
        jnp.zeros((1, S)), jnp.zeros((1, 4), jnp.int32), 0,
        train=False))["params"]
    return model, _seeded(shapes, seed)


def port_full(params, cfg=FULL, encoder_type="full"):
    model = port_w2v2.Wav2Vec2Model(
        port_cfg(port_w2v2.Wav2Vec2Config, cfg), pretraining=True,
        encoder_type=encoder_type)
    model.load_state_dict(wav2vec2_state_dict_from_jax(params), strict=True)
    return model


def _padded_source(seed=0, B=3):
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, S)) * 0.3).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[2, 1800:] = True
    return src, pad


def _close(got, want, rtol=1e-5, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _grads_close(got: dict, want: dict, rtol=1e-4, atol_rel=1e-6):
    assert got.keys() == want.keys()
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k, v in want.items():
        _close(got[k], v, rtol, atol_rel * scale, k)


# -- the group norm, the front-end, the conv positions --------------------


def _gn64(x, w, b, groups, eps=1e-5):
    """Fp32GroupNorm's formula in float64."""
    B, T, C = x.shape
    g = x.reshape(B, T, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(B, T, C) * w + b


@pytest.mark.parametrize("groups", [16, 4])
def test_fp32_group_norm_matches_jax_and_float64(groups):
    rng = np.random.default_rng(groups)
    x = (rng.standard_normal((3, 50, 16)) * 2.0 + 1.5).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    b = (0.2 * rng.standard_normal(16)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    norm = jax_modules.Fp32GroupNorm(groups, 16)

    def jax_fn(x, scale, bias):
        y = norm.apply({"params": {"scale": scale, "bias": bias}}, x)
        return jnp.sum(y * r), y

    (_, want), want_g = jax.value_and_grad(jax_fn, (0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    y = fp32_group_norm(ins[0], ins[1], ins[2], groups)
    (y * torch.from_numpy(r)).sum().backward()
    _close(y.detach(), want)
    got_g = {n: t.grad.numpy() for n, t in zip("xwb", ins)}
    _grads_close(got_g, dict(zip("xwb", map(np.asarray, want_g))))
    # float64: the same formula, every input in double
    ins64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
             for a in (x, w, b)]
    y64 = _gn64(*ins64, groups)
    (y64 * torch.from_numpy(r).double()).sum().backward()
    _close(y.detach(), y64.detach(), what="forward vs float64")
    _grads_close(got_g, {n: t.grad.numpy() for n, t in zip("xwb", ins64)})


def _front_end_state(p):
    """The JAX ConvFeatureExtractor tree -> the port module's state dict."""
    out = {}
    for name, leaf in p.items():
        kind, i = name.split("_")
        base = f"conv_layers.{i}"
        if kind == "conv":
            out[base + ".0.weight"] = np.transpose(leaf["kernel"], (2, 1, 0))
        else:
            norm = base + (".2.1" if kind == "ln" else ".2")
            out[norm + ".weight"], out[norm + ".bias"] = (leaf["scale"],
                                                         leaf["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_front_end_matches_jax(mode):
    layers = FULL.conv_feature_layers
    jmod = jax_fe.ConvFeatureExtractor(conv_layers=layers, mode=mode,
                                       layer_norm_num=1)
    src, _ = _padded_source()
    params = _seeded(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S))))["params"], 5)
    assert ("gn_0" in params) == (mode == "default")
    r = np.random.default_rng(1).standard_normal(
        (3, jax_fe.conv_output_length(S, layers), 16)).astype(np.float32)

    def jax_fn(p, x):
        y = jmod.apply({"params": p}, x)
        return jnp.sum(y * r), y

    (_, want), (gp, gx) = jax.value_and_grad(jax_fn, (0, 1), has_aux=True)(
        params, jnp.asarray(src))
    mod = ConvFeatureExtractor(layers, 1, False, mode)
    mod.load_state_dict(_front_end_state(params), strict=True)
    x = torch.tensor(src, requires_grad=True)
    y = mod(x)
    (y * torch.from_numpy(r)).sum().backward()
    _close(y.detach(), want)
    got = {k: p.grad.numpy() for k, p in mod.named_parameters()}
    got["source"] = x.grad.numpy()
    want_g = {k: v.numpy() for k, v in _front_end_state(
        jax.device_get(gp)).items()}
    want_g["source"] = np.asarray(gx)
    _grads_close(got, want_g)


@pytest.mark.parametrize("kernel", [8, 7])
def test_conv_positions_match_jax(kernel):
    jmod = jax_w2v2.ConvPositionalEmbedding(24, kernel, 4)
    rng = np.random.default_rng(kernel)
    x = rng.standard_normal((2, 30, 24)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    params = _seeded(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 30, 24))))["params"], 6)

    def jax_fn(p, x):
        y = jmod.apply({"params": p}, x)
        return jnp.sum(y * r), y

    (_, want), (gp, gx) = jax.value_and_grad(jax_fn, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    mod = port_w2v2.ConvPositionalEmbedding(24, kernel, 4)
    mod.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(np.transpose(
            params["conv"]["kernel"], (2, 1, 0)))),
        "bias": torch.from_numpy(params["conv"]["bias"])})
    xt = torch.tensor(x, requires_grad=True)
    y = mod(xt)
    assert y.shape == (2, 30, 24)
    (y * torch.from_numpy(r)).sum().backward()
    _close(y.detach(), want)
    _grads_close({"x": xt.grad.numpy(), "weight": mod.weight.grad.numpy(),
                  "bias": mod.bias.grad.numpy()},
                 {"x": np.asarray(gx), "weight": np.transpose(
                     np.asarray(gp["conv"]["kernel"]), (2, 1, 0)),
                  "bias": np.asarray(gp["conv"]["bias"])})


# -- the full-context model ---------------------------------------------------


@pytest.mark.parametrize("cfg", [FULL, FULL_PRELN], ids=["post_ln", "pre_ln"])
def test_full_extract_features_match_jax(cfg):
    model_j, params = jax_full(cfg)
    src, pad = _padded_source()
    want, want_pad = model_j.apply(
        {"params": params}, jnp.asarray(src), jnp.asarray(pad),
        method=model_j.extract_features)
    model = port_full(params, cfg)
    assert isinstance(model.encoder, port_w2v2.TransformerEncoder)
    with torch.no_grad():
        got, got_pad = model.extract_features(torch.from_numpy(src),
                                              torch.from_numpy(pad))
    np.testing.assert_array_equal(got_pad.numpy(), np.asarray(want_pad))
    _close(got, want)
    # the block context is no argument of the full encoder
    with torch.no_grad():
        again, _ = model.extract_features(torch.from_numpy(src),
                                          torch.from_numpy(pad), 4, 2)
    assert torch.equal(again, got)


def test_full_pretraining_loss_and_every_gradient_match_jax(monkeypatch):
    model_j, params = jax_full()
    batch = make_batch(cfg=FULL)
    draws = Draws(monkeypatch)
    model = port_full(params)
    loss, n, logs = make_pretrain_loss_fn(model, 8, 4)(
        to_torch(batch), torch.Generator().manual_seed(0), 3)
    loss.backward()
    draws.plant()
    loss_fn = jax_recipes.make_pretrain_loss_fn(model_j, 8, 4)
    (want_loss, (want_n, want_logs)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        params, to_jax(batch), jax.random.PRNGKey(0), 3)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert n == int(want_n)
    for k, v in logs.items():
        np.testing.assert_allclose(float(v.detach()), float(want_logs[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads_equal(model, jax.device_get(want_grads))
    assert model.encoder.pos_conv[0].weight.grad.abs().max() > 0


def test_caat_loss_and_every_gradient_with_the_group_norm_encoder():
    w2v = dataclasses.replace(caat_train.W2V, extractor_mode="default")
    want_loss, _, _, want = caat_train.jax_grads(w2v)
    model = port_caat(jax_caat(w2v, caat_train.CAAT)[1], w2v,
                      caat_train.CAAT)
    assert isinstance(model.encoder.w2v2_model.feature_extractor
                      .conv_layers[0][2], torch.nn.GroupNorm)
    loss, _ = caat_train.port_loss(model, caat_train.make_batch())
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    loss.backward()
    caat_train._assert_grads_equal(model, want)


# -- checkpoints --------------------------------------------------------------


@pytest.mark.parametrize("encoder_type", ["full", "blockwise"])
def test_fairseq_pt_gives_equal_outputs_in_both_packages(encoder_type):
    """A full model's state dict with fairseq's names (weight-normed conv
    positions, the block-0 group norm): the full import keeps and folds
    the positions, the blockwise one drops them, in both packages."""
    sd = fairseq_style_state_dict(FULL, encoder_type="full")
    params = jax_import.import_wav2vec2_params(sd, FULL, encoder_type)
    model_j = jax_w2v2.Wav2Vec2Model(FULL, encoder_type=encoder_type)
    src, pad = _padded_source(1)
    want, _ = model_j.apply({"params": params}, jnp.asarray(src),
                            jnp.asarray(pad), 4, 2,
                            method=model_j.extract_features)
    model = torch_import.load_wav2vec2_(port_w2v2.Wav2Vec2Model(
        port_cfg(port_w2v2.Wav2Vec2Config, FULL), pretraining=True,
        encoder_type=encoder_type), sd)
    with torch.no_grad():
        got, _ = model.extract_features(torch.from_numpy(src),
                                        torch.from_numpy(pad), 4, 2)
    _close(got, want)
    keys = set(model.state_dict())
    assert ("encoder.pos_conv.0.weight" in keys) == (encoder_type == "full")
    assert "feature_extractor.conv_layers.0.2.weight" in keys


@pytest.mark.parametrize("encoder_type", ["full", "blockwise"])
def test_port_export_equals_jax_export(encoder_type):
    _, params = jax_full(FULL, encoder_type)
    want = jax_export.export_wav2vec2_params(params)
    got = torch_export.export_wav2vec2_state_dict(
        port_full(params, FULL, encoder_type))
    assert sorted(got) == sorted(want)
    if encoder_type == "full":
        assert {"encoder.pos_conv.0.weight_g",
                "encoder.pos_conv.0.weight_v"} <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_convert_cli_full_round_trip(tmp_path):
    """A JAX-exported full model whose stored cfg says
    ``extractor_mode: default``: import with ``--encoder-type full`` gives
    the converted parameters exactly (the fold of an exported pair is
    exact); export gives the input ``.pt`` back, value for value."""
    _, params = jax_full()
    sd = jax_export.export_wav2vec2_params(params)
    jax_export.save_fairseq_checkpoint(
        tmp_path / "in.pt", sd, {"model": {"extractor_mode": "default"}})
    widths = [f"{k}={getattr(FULL, k)!r}".replace(" ", "") for k in (
        "conv_feature_layers", "encoder_layers", "encoder_embed_dim",
        "encoder_ffn_embed_dim", "encoder_attention_heads", "final_dim",
        "latent_vars", "conv_pos", "conv_pos_groups")]
    convert_cli.main(["--pt", str(tmp_path / "in.pt"), "--out",
                      str(tmp_path / "ck"), "--encoder-type", "full"]
                     + widths)
    got = load_params(tmp_path / "ck")
    want = wav2vec2_state_dict_from_jax(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    convert_cli.main(["--export-from", str(tmp_path / "ck"), "--out",
                      str(tmp_path / "out.pt")])
    back = torch_import.load_torch_checkpoint(tmp_path / "out.pt")["model"]
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # the blockwise import of the same file drops the positions
    convert_cli.main(["--pt", str(tmp_path / "in.pt"), "--out",
                      str(tmp_path / "bw")] + widths)
    bw = load_params(tmp_path / "bw")
    assert sorted(bw) == sorted(k for k in want if "pos_conv" not in k)


def test_warm_start_reads_a_group_norm_pt(tmp_path):
    """``run.w2v2_model_path`` / ``run.pretrained_encoder_path`` with a
    stock-layout group-norm ``.pt``: the CAAT encoder takes its weights,
    the group norm included, the conv positions dropped."""
    w2v = dataclasses.replace(W2V, extractor_mode="default")
    sd = fairseq_style_state_dict(FULL, encoder_type="full")
    torch_export.save_fairseq_checkpoint(tmp_path / "w2v.pt", sd)
    model = W2V2CaatModel(port_cfg(port_w2v2.Wav2Vec2Config, w2v),
                          port_cfg(CaatConfig, caat_train.CAAT))
    apply_pretrained_encoder(model, tmp_path / "w2v.pt")
    enc = model.encoder.w2v2_model.state_dict()
    heads = ("quantizer.", "project_q.", "final_proj.", "encoder.pos_conv.")
    want = {k: v for k, v in sd.items() if not k.startswith(heads)}
    assert sorted(enc) == sorted(want)
    for k, v in want.items():
        assert torch.equal(enc[k], v.float()), k


# -- the trainer ----------------------------------------------------------


CLI_W2V = dataclasses.replace(
    W2V, conv_feature_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
    encoder_embed_dim=32, encoder_ffn_embed_dim=64, final_dim=16,
    latent_vars=8, n_negatives=5, extractor_mode="default", conv_pos=16,
    conv_pos_groups=4)


def test_pretrain_cli_from_a_stock_pt_equals_jax_cli(audio_corpus,
                                                     monkeypatch):
    """``model.extractor_mode=default`` with a stock-layout ``.pt`` (the
    group norm, weight-normed conv positions, the heads): the port's run
    starts from the weights that the JAX CLI's ``init_params`` imports
    (blockwise: positions dropped), and on the first batch of the epoch the
    two CLIs' models and recipes give one loss under the same draws."""
    sd = fairseq_style_state_dict(CLI_W2V, encoder_type="full", seed=4)
    torch_export.save_fairseq_checkpoint(audio_corpus / "stock.pt", sd)
    extra = {"run.load_pretrained_model_from": audio_corpus / "stock.pt",
             "model.extractor_mode": "default", "run.max_update": 0,
             "model.attention_impl": "dense", "model.pos_type": "conv",
             "model.feature_grad_mult": 0.1,
             "context.context_type": "constant",
             **{f"model.{k}": 0.0 for k in (
                 "dropout", "attention_dropout", "activation_dropout",
                 "dropout_input", "dropout_features")}}
    argv = pretrain_argv(audio_corpus, "stock", **extra)
    cli.main(argv)
    start, _ = CheckpointManager(audio_corpus / "stock",
                                 keep_last=0).restore()
    jcfg = jax_config.load_config(None, argv[2:])
    _, jbatcher, model_j, jmake_loss, init_params = jax_cli.build_pretrain(
        jcfg)
    pcfg = cli.load_config(None, argv[2:])
    _, batcher, model, make_loss = cli.build_pretrain(pcfg)
    batch = batcher.collate(np.arange(3), key=(1, 0))
    params = init_params(batch)
    want = wav2vec2_state_dict_from_jax(params)
    assert sorted(start["model"]) == sorted(want)
    assert "feature_extractor.conv_layers.0.2.weight" in want
    assert not any("pos_conv" in k for k in want)
    for k, v in want.items():
        assert torch.equal(start["model"][k], v), k
        assert torch.equal(model.state_dict()[k], v), k

    draws = Draws(monkeypatch)
    mc, rc = pcfg.context.main_context, pcfg.context.right_context
    loss, n, logs = make_loss(mc, rc)(to_torch(batch),
                                      torch.Generator().manual_seed(0), 0)
    draws.plant()
    want_loss, (want_n, want_logs) = jax.jit(jmake_loss(mc, rc))(
        params, to_jax(batch), jax.random.PRNGKey(0), 0)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert n == int(want_n)
    for k in ("loss_infonce", "correct", "count", "prob_perplexity"):
        np.testing.assert_allclose(float(logs[k]), float(want_logs[k]),
                                   rtol=1e-5, err_msg=k)


def test_caat_cli_from_a_stock_pt_keeps_the_group_norm(corpus,
                                                       audio_corpus):
    """``run.task=caat model.extractor_mode=default run.w2v2_model_path=``
    a stock-layout ``.pt``: the encoder before the first update is the
    imported one, and the run updates."""
    sd = fairseq_style_state_dict(dataclasses.replace(
        CLI_W2V, encoder_layers=2), encoder_type="full", seed=5)
    torch_export.save_fairseq_checkpoint(audio_corpus / "stock.pt", sd)

    def argv(max_update):
        out = caat_overrides(corpus, "caat_gn", **{
            "run.w2v2_model_path": audio_corpus / "stock.pt",
            "model.extractor_mode": "default",
            "run.max_update": max_update})
        return out

    cli.main(argv(0))
    start, _ = CheckpointManager(corpus[0] / "caat_gn",
                                 keep_last=0).restore()
    enc = {k[len("encoder.w2v2_model."):]: v
           for k, v in start["model"].items()
           if k.startswith("encoder.w2v2_model.")}
    heads = ("quantizer.", "project_q.", "final_proj.", "encoder.pos_conv.")
    assert sorted(enc) == sorted(k for k in sd if not k.startswith(heads))
    for k, v in enc.items():
        assert torch.equal(v, sd[k].float()), k
    cli.main(argv(1))
    start2, _ = CheckpointManager(corpus[0] / "caat_gn",
                                  keep_last=0).restore()
    assert start2["step"] == 1


def test_incremental_encoder_still_refuses_the_group_norm():
    from wav2vec_s_tpu_torch.stream.incremental import (
        IncrementalBlockwiseEncoder)

    cfg = port_cfg(port_w2v2.Wav2Vec2Config, FULL)
    with pytest.raises(ValueError, match="group-norm"):
        IncrementalBlockwiseEncoder(cfg, port_w2v2.Wav2Vec2Model(cfg), 1)
