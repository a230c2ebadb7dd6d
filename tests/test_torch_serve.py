"""``demo/serve_torch.py`` against ``demo/serve.py`` on the CPU: the JAX
demo's handler and the port's, each on its own server thread, over the same
tiny late-fusion weights (the port's from ``models/from_jax.py``) and the
same sample files. tests/test_demo_server.py is the pattern.
"""
import dataclasses
import importlib.util
import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.data import sample_data as jsample
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.serving import MultimodalEmotionDemo as JaxDemo
from simple_multimodal_tpu.train import checkpoint as jcheckpoint
from simple_multimodal_tpu.train.state import TrainState as JaxState
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel)
from simple_multimodal_tpu_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]
LABELS = ["happy", "sad", "angry", "fear", "surprise", "disgust", "neutral"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_serve = _load("serve", "demo/serve.py")
serve = _load("serve_torch", "demo/serve_torch.py")


@pytest.fixture(scope="module")
def servers(tiny_config, tmp_path_factory):
    """Both servers on port 0, the data directory they share, the port's
    checkpoint."""
    base = tmp_path_factory.mktemp("serve")
    data_dir = str(base / "data")
    jsample.create_sample_dataset(data_dir, num_samples_per_emotion=1, duration=0.3)
    cfg = dataclasses.replace(tiny_config)
    cfg.fusion_type = "late"  # the per-modality breakdown too
    rng = np.random.default_rng(0)
    text = {"input_ids": rng.integers(0, 1000, (1, cfg.text_max_length)).astype(np.int32),
            "attention_mask": np.ones((1, cfg.text_max_length), np.int32)}
    audio = rng.standard_normal((1, cfg.audio_max_length)).astype(np.float32)
    video = rng.integers(0, 255, (1, cfg.video_max_frames, *cfg.video_frame_size, 3)
                         ).astype(np.uint8)
    model = MultimodalEmotionModel(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), text, audio, video))
    jck = str(base / "jax_ck")
    jcheckpoint.save_checkpoint(jck, JaxState(step=0, params=params, opt_state=None,
                                              rng=jax.random.PRNGKey(0)),
                                epoch=0, config=cfg)
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    port = PortModel(pcfg)
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    pck = str(base / "port_ck")
    checkpoint.save_checkpoint(pck, port, config=pcfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)  # no HF lookup: HashTokenizer
        demos = {"jax": JaxDemo(jck, config=cfg),
                 "port": serve.load_demo(pck, device="cpu")}
    made = {}
    for name, module in (("jax", jax_serve), ("port", serve)):
        server = ThreadingHTTPServer(("127.0.0.1", 0),
                                     module.make_handler(demos[name], media_dir=data_dir))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        made[name] = server
    yield {k: s.server_address[1] for k, s in made.items()}, data_dir, pck
    for server in made.values():
        server.shutdown()
        server.server_close()


def _post(port, body: bytes, content_type: str) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/analyze", data=body,
                                 headers={"Content-Type": content_type})
    return json.loads(urllib.request.urlopen(req, timeout=300).read())


def _same_analysis(got, want):
    assert got["predicted_emotion"] == want["predicted_emotion"]
    assert list(got["emotion_distribution"]) == LABELS
    np.testing.assert_allclose(list(got["emotion_distribution"].values()),
                               list(want["emotion_distribution"].values()), atol=1e-4)
    assert set(got["individual_modalities"]) == set(want["individual_modalities"]) == {
        "text", "audio", "video"}
    for m, view in want["individual_modalities"].items():
        np.testing.assert_allclose(list(got["individual_modalities"][m]["distribution"].values()),
                                   list(view["distribution"].values()), atol=1e-4)


def test_page_is_the_jax_page(servers):
    ports, _, _ = servers
    pages = {k: urllib.request.urlopen(f"http://127.0.0.1:{p}/", timeout=60).read().decode()
             for k, p in ports.items()}
    assert pages["port"] == pages["jax"].replace("(TPU-native)</h1>", "(PyTorch port)</h1>")
    assert pages["port"] != pages["jax"]


def test_json_paths_match_jax(servers):
    ports, data_dir, _ = servers
    body = json.dumps({"text": "my boss at work made this the best day ever",
                       "audio_path": "audio/happy_000.wav",
                       "video_path": "video/happy_000.mp4"}).encode()
    got, want = (_post(ports[k], body, "application/json") for k in ("port", "jax"))
    _same_analysis(got["emotion_analysis"], want["emotion_analysis"])
    assert "Work situations" in got["ai_response"]
    assert got["emotion_chart"]["labels"] == LABELS and len(got["history"]) >= 1
    assert set(got) == set(want)


def test_multipart_uploads_match_jax(servers):
    ports, data_dir, _ = servers
    boundary = "smmboundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="text"\r\n\r\n'
             "so scared of the exam\r\n".encode()]
    for field, path, ctype in (("audio", "audio/fear_000.wav", "audio/wav"),
                               ("video", "video/fear_000.mp4", "video/mp4")):
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; '
                     f'filename="{Path(path).name}"\r\nContent-Type: {ctype}\r\n\r\n'.encode()
                     + (Path(data_dir) / path).read_bytes() + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    body, ctype = b"".join(parts), f"multipart/form-data; boundary={boundary}"
    got, want = (_post(ports[k], body, ctype) for k in ("port", "jax"))
    _same_analysis(got["emotion_analysis"], want["emotion_analysis"])


def test_path_outside_the_media_dir_is_refused(servers):
    ports, _, _ = servers
    body = json.dumps({"text": "hi", "audio_path": "../../../etc/passwd"}).encode()
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(ports["port"], body, "application/json")
    assert err.value.code == 500
    assert "escapes media directory" in json.loads(err.value.read())["error"]


def test_cli_request_matches_the_server(servers, capsys, monkeypatch):
    ports, data_dir, pck = servers
    monkeypatch.setitem(sys.modules, "transformers", None)
    serve.main(["--model_path", pck, "--cli", "--device", "cpu", "--text", "a quiet day",
                "--audio", f"{data_dir}/audio/neutral_000.wav",
                "--video", f"{data_dir}/video/neutral_000.mp4"])
    printed = json.loads(capsys.readouterr().out)
    body = json.dumps({"text": "a quiet day", "audio_path": "audio/neutral_000.wav",
                       "video_path": "video/neutral_000.mp4"}).encode()
    served = _post(ports["port"], body, "application/json")["emotion_analysis"]
    assert printed["emotion_analysis"]["emotion_distribution"] == served["emotion_distribution"]


def test_the_card_is_the_default(servers):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, pck = servers
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--model_path", pck, "--cli"])
