"""The whole serving slice of the port against the JAX model: the tiny
hierarchical ``MultimodalEmotionModel`` initialised in JAX from a PRNG key,
carried over with ``state_dict_from_jax``, compared in f32 on CPU at 1e-3
(tests/test_full_model_parity.py's tolerance); the exact parameter round
trip through ``convert_multimodal_model``; the serving demo; and the rule
that importing the port loads no jax.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.models.convert_full import convert_multimodal_model
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.data.video_wire import pack_yuv420
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel, create_model,
)
from simple_multimodal_tpu_torch.serving.demo import (
    MultimodalEmotionDemo, save_checkpoint,
)

PARITY_KEYS = ("text_features", "audio_features", "video_features",
               "emotion_logits", "valence", "arousal")
TOL = dict(atol=1e-3, rtol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def slice_(tiny_config):
    cfg = dataclasses.replace(tiny_config, fusion_dropout=0.0)
    cfg.fusion_type = "hierarchical"
    rng = np.random.default_rng(0)
    B = 2
    ids = rng.integers(1, 120000, (B, cfg.text_max_length)).astype(np.int32)
    mask = np.ones((B, cfg.text_max_length), np.int32)
    mask[1, 10:] = 0
    audio = rng.standard_normal((B, cfg.audio_max_length)).astype(np.float32)
    video = rng.integers(0, 256, (B, cfg.video_max_frames, 32, 32, 3), dtype=np.uint8)
    model = MultimodalEmotionModel(cfg)
    text = {"input_ids": ids, "attention_mask": mask}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), text, audio, video)
    params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    port = PortModel(pcfg).eval()
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    return cfg, pcfg, model, params, port, (text, audio, video)


def _port_inputs(text, audio, video):
    return ({k: torch.from_numpy(v) for k, v in text.items()},
            torch.from_numpy(audio), torch.from_numpy(video))


@pytest.mark.parametrize("missing", [None, ("text",), ("audio", "video")])
def test_slice_matches_jax(slice_, missing):
    cfg, pcfg, model, params, port, inputs = slice_
    want = jax.jit(lambda p, t, a, v: model.apply(p, t, a, v, missing_modalities=missing))(
        params, *inputs)
    with torch.no_grad():
        got = port(*_port_inputs(*inputs), missing_modalities=missing)
    for key in PARITY_KEYS + ("emotion_probs", "uncertainty"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)
    assert set(got) == set(want)


def test_bf16_probabilities_are_softmaxed_in_the_compute_dtype(slice_):
    """Under bf16 the JAX model softmaxes its logits in bf16; so does the
    port (``emotion_probs``, ``uncertainty``, the eval step's ``probs``).
    Port against JAX on converted weights: 3e-2 (bf16 rounding through the
    whole model), each distribution summing to 1 within 1e-2."""
    import jax.numpy as jnp

    from simple_multimodal_tpu_torch.train.steps import make_eval_step

    cfg, pcfg, model, params, port, inputs = slice_
    jmodel = MultimodalEmotionModel(cfg, dtype=jnp.bfloat16)
    want = jax.jit(jmodel.apply)(params, *inputs)
    bport = PortModel(pcfg, dtype=torch.bfloat16).eval()
    bport.load_state_dict(port.state_dict())
    text, audio, video = _port_inputs(*inputs)
    with torch.no_grad():
        got = bport(text, audio, video)
    for key in ("emotion_probs", "uncertainty"):
        assert got[key].dtype == torch.bfloat16 and want[key].dtype == jnp.bfloat16
        g, w = got[key].float().numpy(), np.asarray(want[key].astype(jnp.float32))
        np.testing.assert_allclose(g, w, atol=3e-2, rtol=0, err_msg=key)
        np.testing.assert_allclose(g.sum(-1), 1.0, atol=1e-2, err_msg=key)
    assert torch.equal(got["emotion_probs"], torch.softmax(got["emotion_logits"], dim=-1))
    step = make_eval_step(bport, compute_loss=False)
    out = step({"text": text, "audio": audio, "video": video})
    assert out["probs"].dtype == torch.bfloat16
    assert torch.equal(out["probs"], torch.softmax(out["logits"], dim=-1))
    np.testing.assert_allclose(out["probs"].float().numpy().sum(-1), 1.0, atol=1e-2)


def test_slice_matches_jax_on_yuv420_video(slice_):
    cfg, pcfg, model, params, port, (text, audio, video) = slice_
    packed = pack_yuv420(video)
    want = jax.jit(model.apply)(params, text, audio, packed)
    with torch.no_grad():
        got = port(*_port_inputs(text, audio, packed))
    for key in PARITY_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)


def test_param_round_trip_is_exact(slice_):
    cfg, pcfg, model, params, port, _ = slice_
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, pcfg).items()}
    back = convert_multimodal_model(sd, cfg)
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    # the port's own state_dict carries every parameter the converter reads
    assert set(sd) == set(port.state_dict())


def test_demo_predict_returns_a_distribution(slice_, tmp_path):
    cfg, pcfg, model, params, port, (text, audio, video) = slice_
    ckpt = str(tmp_path / "model")
    save_checkpoint(ckpt, port, pcfg)
    demo = MultimodalEmotionDemo(checkpoint_path=ckpt, device="cpu")
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal(pcfg.audio_max_length) * 3000).astype(np.int16)
    for a, v in ((None, None), (wav, None), (wav, video[0]), (audio[0], pack_yuv420(video[0]))):
        analysis = demo.predict("I am so happy today!", a, v)
        dist = analysis["emotion_distribution"]
        assert list(dist) == list(pcfg.emotion_labels)
        assert abs(sum(dist.values()) - 1.0) < 1e-5
        assert analysis["predicted_emotion"] == max(dist, key=dist.get)
    # the loaded checkpoint reproduces the model it was saved from
    with torch.no_grad():
        want = port(*demo.prepare("same weights", wav, video[0]))
    got = demo.forward("same weights", wav, video[0])
    np.testing.assert_array_equal(got["emotion_logits"].numpy(), want["emotion_logits"].numpy())
    out = demo.process_multimodal_input("work is fine", wav, video[0])
    assert out[0]["confidence"] > 0 and isinstance(out[1], str) and out[3]["type"] == "bar"
    assert len(demo.conversation_history) == 1


def test_demo_refuses_files_until_the_data_path_is_ported(slice_, tmp_path):
    """The data path is ported: ``predict`` decodes file paths as the JAX
    demo does. A path that is not there reads as zeros (the JAX loaders'
    rule for missing media), so it answers as None does; the UI entry
    point serves a missing clip instead of returning an error tuple."""
    cfg, pcfg, model, params, port, _ = slice_
    demo = MultimodalEmotionDemo(model=port, config=pcfg, device="cpu")
    missing = str(tmp_path / "clip.wav")
    assert demo.predict("hello", audio=missing) == demo.predict("hello", audio=None)
    analysis, message, *_ = demo.process_multimodal_input("hello",
                                                          video=str(tmp_path / "clip.mp4"))
    assert analysis == demo.predict("hello") and not message.startswith("Error")


def test_unported_options_raise(slice_):
    """What the port still refuses: an unknown model type; and the
    training modes that are not ported yet, each naming its ROADMAP item
    (tests/test_torch_cli.py). An spm tokenizer and media files, refused
    before, are ported: an spm path that does not exist falls back to
    HashTokenizer, as in the JAX package (tests/test_torch_data.py)."""
    from simple_multimodal_tpu_torch.data.tokenizer import HashTokenizer, get_tokenizer

    cfg, pcfg, model, params, port, inputs = slice_
    assert isinstance(get_tokenizer(pcfg.text_model_name, pcfg.text_max_length,
                                    spm_path="model.spm"), HashTokenizer)
    with pytest.raises(ValueError, match="Unknown model type"):
        create_model(pcfg, model_type="no-such-family", device="cpu")


def test_create_model_is_seeded_and_f32_on_cpu(slice_):
    pcfg = slice_[1]
    a = create_model(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = create_model(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert a.dtype == torch.float32 and not a.training
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import simple_multimodal_tpu_torch\n"
            "import simple_multimodal_tpu_torch.serving.demo\n"
            "import simple_multimodal_tpu_torch.models.from_jax\n"
            "import simple_multimodal_tpu_torch.ops.hopper\n"
            "import simple_multimodal_tpu_torch.ops.adapters\n"
            "import simple_multimodal_tpu_torch.data.augment\n"
            "import simple_multimodal_tpu_torch.train.losses\n"
            "import simple_multimodal_tpu_torch.train.optim\n"
            "import simple_multimodal_tpu_torch.train.state\n"
            "import simple_multimodal_tpu_torch.train.steps\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'transformers', 'cv2', 'simple_multimodal_tpu')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
