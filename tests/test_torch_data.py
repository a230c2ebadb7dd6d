"""The port's host data path against the JAX package's, on the CPU: the
configs' JSON, WAV I/O and the resampler, the native decoder, the sample
generator (and its clip store without OpenCV), datasets and loaders,
splits, the sentencepiece reader and tokenizer resolution, the metrics,
and the host side of the pipeline. Equal means byte-equal unless a
tolerance is stated.
"""
import dataclasses
import filecmp
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simple_multimodal_tpu import config as jconfig
from simple_multimodal_tpu.data import audio_io as jaudio
from simple_multimodal_tpu.data import dataset as jdataset
from simple_multimodal_tpu.data import pipeline as jpipeline
from simple_multimodal_tpu.data import sample_data as jsample
from simple_multimodal_tpu.data import splits as jsplits
from simple_multimodal_tpu.data import tokenizer as jtokenizer
from simple_multimodal_tpu.data.spm import CONTROL, NORMAL, UNKNOWN, serialize_model_proto
from simple_multimodal_tpu.data.video_wire import pack_yuv420 as jpack
from simple_multimodal_tpu.eval.metrics import calculate_metrics as jmetrics
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.data import audio_io, native, pipeline, sample_data, splits
from simple_multimodal_tpu_torch.data import dataset as pdataset
from simple_multimodal_tpu_torch.data import tokenizer as ptokenizer
from simple_multimodal_tpu_torch.data import video_io
from simple_multimodal_tpu_torch.eval.metrics import calculate_metrics

SPLITS = ("train", "val", "test")


def _assert_same(a, b, where=""):
    """Equal values of equal types, shapes and dtypes, recursively."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            _assert_same(x, y, where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _port_cfg(cfg):
    return pconfig.config_from_dict(pconfig.ModelConfig, jconfig.config_to_dict(cfg))


@pytest.fixture(scope="module", autouse=True)
def _no_hf_lookup():
    """Both packages' ``get_tokenizer`` try the HF tokenizer first; with no
    local HF cache here that costs an import of transformers (~9 s) and
    ends in HashTokenizer all the same."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The sample set of both generators at seed 42, two clips per emotion,
    at difficulty 0 and 0.5."""
    out = {}
    for d in (0.0, 0.5):
        root = tmp_path_factory.mktemp(f"gen{d}")
        out[d] = (jsample.create_sample_dataset(str(root / "jax"), 2, seed=42, difficulty=d),
                  sample_data.create_sample_dataset(str(root / "port"), 2, seed=42,
                                                    difficulty=d))
    return out


# ------------------------------------------------------------------- config

def test_config_json_round_trip_matches_jax(tmp_path):
    paths = {k: str(tmp_path / k) for k in ("data_path", "save_path", "log_path")}
    jm, pm = jconfig.ModelConfig(**paths), pconfig.ModelConfig(**paths)
    jm.fusion_type = pm.fusion_type = "hierarchical"  # attached after construction, as the CLI
    jconfig.save_config_json(str(tmp_path / "j.json"), model_config=jm,
                             data_config=jconfig.DataConfig(),
                             experiment_config=jconfig.ExperimentConfig())
    pconfig.save_config_json(str(tmp_path / "p.json"), model_config=pm,
                             data_config=pconfig.DataConfig(),
                             experiment_config=pconfig.ExperimentConfig())
    want, got = (jconfig.load_config_json(str(tmp_path / f)) for f in ("j.json", "p.json"))
    # the port's own fields (the DeepSeek text tower's cut), which the JAX package lacks
    port_only = {"text_num_layers": 0, "text_expert_share": [0, 1]}
    assert {k: got["model_config"].pop(k) for k in port_only} == port_only
    assert got == want
    for name, cls in (("model_config", pconfig.ModelConfig), ("data_config", pconfig.DataConfig),
                      ("experiment_config", pconfig.ExperimentConfig)):
        back = pconfig.config_to_dict(pconfig.config_from_dict(cls, got[name]))
        if name == "model_config":
            assert {k: back.pop(k) for k in port_only} == port_only
        assert back == want[name], name
    assert ({f.name for f in dataclasses.fields(pconfig.DataConfig)}
            == {f.name for f in dataclasses.fields(jconfig.DataConfig)})
    assert ({f.name for f in dataclasses.fields(pconfig.ExperimentConfig)}
            == {f.name for f in dataclasses.fields(jconfig.ExperimentConfig)})


# -------------------------------------------------------------------- audio

def test_wav_io_resample_and_load_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    mono = (0.7 * rng.standard_normal(7000)).astype(np.float32)  # clips at ±1
    stereo = (0.4 * rng.standard_normal((2, 5000))).astype(np.float32)
    for name, wav, rate in (("mono", mono, 44100), ("stereo", stereo, 22050),
                            ("native_rate", mono, 16000)):
        jaudio.write_wav(tmp_path / f"j_{name}.wav", wav, rate)
        audio_io.write_wav(tmp_path / f"p_{name}.wav", wav, rate)
        assert filecmp.cmp(tmp_path / f"j_{name}.wav", tmp_path / f"p_{name}.wav",
                           shallow=False), name
        jw, jr = jaudio.read_wav(tmp_path / f"j_{name}.wav")
        pw, pr = audio_io.read_wav(tmp_path / f"j_{name}.wav")
        assert pr == jr
        _assert_same(pw, jw, name)
        for dst in (16000, 8000):
            _assert_same(audio_io.resample_np(pw, pr, dst), jaudio.resample_np(jw, jr, dst),
                         f"{name}->{dst}")
        for max_len in (3000, 40000):
            _assert_same(
                audio_io.load_audio_fixed(tmp_path / f"j_{name}.wav", 16000, max_len,
                                          use_native=False),
                jaudio.load_audio_fixed(tmp_path / f"j_{name}.wav", 16000, max_len,
                                        use_native=False), f"{name} {max_len}")
    for src, dst in ((44100, 16000), (48000, 16000), (22050, 16000)):
        _assert_same(audio_io._sinc_kernel(src, dst), jaudio._sinc_kernel(src, dst))
    _assert_same(audio_io.load_audio_fixed(tmp_path / "missing.wav", 16000, 100),
                 jaudio.load_audio_fixed(tmp_path / "missing.wav", 16000, 100))


def test_native_decoder_matches_numpy_and_builds_under_build(tmp_path):
    """The native decoder against the numpy one, within the JAX package's
    own test tolerance (tests/test_native.py); built under build/native,
    never over the tracked native/libsmmdata.so."""
    assert native.available(), native._build_error
    assert native.decoder() == "native"
    assert Path(native._so_path()).parent == Path(native._ROOT) / "build" / "native"
    assert Path(native._lib._name) == Path(native._so_path())
    rng = np.random.default_rng(1)
    paths = []
    for rate in (16000, 44100, 22050):
        t = np.arange(int(rate * 0.5)) / rate
        wav = (0.5 * np.sin(2 * np.pi * 440 * t)
               + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        audio_io.write_wav(tmp_path / f"tone_{rate}.wav", wav, rate)
        paths.append(str(tmp_path / f"tone_{rate}.wav"))
    for path in paths:
        ours = native.decode_audio(path, 16000, 12000)
        ref = audio_io.load_audio_fixed(path, 16000, 12000, use_native=False)
        np.testing.assert_array_equal(ours == 0, ref == 0)
        nz = ref != 0
        assert np.abs(ours[nz] - ref[nz]).mean() < 5e-3, path
    # at the native rate decode is a plain int16 → f32 conversion: exact
    np.testing.assert_array_equal(
        audio_io.load_audio_fixed(paths[0], 16000, 9000),
        audio_io.load_audio_fixed(paths[0], 16000, 9000, use_native=False))


# -------------------------------------------------------------- sample data

def _decode_all(path):
    import cv2

    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("difficulty", [0.0, 0.5])
def test_sample_dataset_matches_jax(generated, difficulty):
    jroot, proot = map(Path, generated[difficulty])
    names = sorted(p.relative_to(jroot).as_posix() for p in jroot.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(proot).as_posix() for p in proot.rglob("*")
                           if p.is_file())
    assert len([n for n in names if n.endswith(".wav")]) == 14
    for name in names:
        if name.endswith(".mp4"):
            _assert_same(_decode_all(proot / name), _decode_all(jroot / name), name)
        else:
            assert filecmp.cmp(jroot / name, proot / name, shallow=False), name


@pytest.fixture(scope="module")
def sidecar_set(tmp_path_factory):
    """The port's sample set generated as on a host without OpenCV."""
    root = tmp_path_factory.mktemp("sidecar")
    saved = video_io._HAS_CV2
    video_io._HAS_CV2 = False
    try:
        path = sample_data.create_sample_dataset(str(root / "set"), 2, seed=42)
    finally:
        video_io._HAS_CV2 = saved
    return Path(path)


def _default_geometry(tiny_config, root, fmt):
    return dataclasses.replace(tiny_config, video_max_frames=30, video_frame_size=(224, 224),
                               video_wire_format=fmt, audio_max_length=16000,
                               data_path=str(root))


@pytest.mark.parametrize("fmt", ["rgb8", "yuv420"])
def test_sidecar_clips_read_the_drawn_frames_in_both_packages(sidecar_set, tiny_config, fmt):
    import json

    meta = json.loads((sidecar_set / "generation_meta.json").read_text())
    assert meta["video_store"] == "sidecar" and meta["video_frames"] == 30
    assert all(p.stat().st_size == 0 for p in (sidecar_set / "video").glob("*.mp4"))
    cfg = _default_geometry(tiny_config, sidecar_set, fmt)
    rng = np.random.default_rng(42)  # the generator's draws, replayed
    drawn_clips = {}
    for e in jsample.EMOTIONS:
        for j in range(2):
            jsample.synth_audio(e, 3.0, rng=rng)
            drawn_clips[f"{e}_{j:03d}"] = jsample.synth_video(e, 3.0, rng=rng)[:30]
    for split in SPLITS:
        jds = jdataset.get_dataset("sample", str(sidecar_set), split, cfg)
        pds = pdataset.get_dataset("sample", str(sidecar_set), split, _port_cfg(cfg))
        for i in range(len(pds)):
            want = jds[i]
            _assert_same(pds[i], want, f"{split}[{i}]")
            drawn = drawn_clips[Path(jds.data[i]["video_path"]).stem]
            assert want["video"].shape[0] == 30
            np.testing.assert_array_equal(want["video"],
                                          drawn if fmt == "rgb8" else jpack(drawn))


def test_sidecar_of_other_geometry_raises(sidecar_set, tiny_config, tmp_path):
    cfg = _port_cfg(dataclasses.replace(tiny_config, data_path=str(sidecar_set),
                                        video_wire_format="rgb8"))
    ds = pdataset.get_dataset("sample", str(sidecar_set), "val", cfg)
    with pytest.raises(ValueError, match=r"\(30, 224, 224, 3\).*\(4, 32, 32, 3\)"):
        ds[0]
    # an empty clip without its sidecar is never decoded to black
    bare = tmp_path / "bare"
    shutil.copytree(sidecar_set, bare, ignore=shutil.ignore_patterns("*.npy"))
    full = _port_cfg(_default_geometry(tiny_config, bare, "rgb8"))
    with pytest.raises(FileNotFoundError, match="sidecar"):
        pdataset.get_dataset("sample", str(bare), "val", full)[0]


def test_demo_reads_the_sidecar_of_an_empty_clip(sidecar_set, tiny_config, monkeypatch):
    """The demo, given the path of an empty clip, serves its sidecar's
    frames as the dataset does (here with OpenCV off, as on a host without
    it), and raises for another geometry instead of serving black."""
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo

    monkeypatch.setattr(video_io, "_HAS_CV2", False)
    clip = str(sidecar_set / "video" / "happy_000.mp4")
    cfg = _port_cfg(_default_geometry(tiny_config, sidecar_set, "rgb8"))
    # decode only: the model is never called
    demo = MultimodalEmotionDemo(model=torch.nn.Identity(), config=cfg, device="cpu")
    video = demo.prepare("a request", None, clip)[2]
    drawn = jsample.synth_video("happy", 3.0)[:30]  # happy draws nothing from the rng
    np.testing.assert_array_equal(video.numpy(), drawn[None])
    tiny = _port_cfg(dataclasses.replace(tiny_config, data_path=str(sidecar_set)))
    demo = MultimodalEmotionDemo(model=torch.nn.Identity(), config=tiny, device="cpu")
    with pytest.raises(ValueError, match=r"\(30, 224, 224, 3\).*\(4, 32, 32, 3\)"):
        demo.prepare("a request", None, clip)


# ----------------------------------------------------------- dataset, loader

@pytest.mark.parametrize("fmt", ["rgb8", "yuv420"])
def test_dataset_items_and_batches_match_jax(generated, tiny_config, tmp_path, fmt):
    """Each package decodes its own copy of the same directory (the
    sidecars one writes must not feed the other); items, the sidecar files
    written, warm (cached) items and two epochs of wrap-padded batches."""
    src = generated[0.0][0]
    jroot, proot = tmp_path / "j", tmp_path / "p"
    shutil.copytree(src, jroot)
    shutil.copytree(src, proot)
    jcfg = dataclasses.replace(tiny_config, video_wire_format=fmt)
    for split in SPLITS:
        jds = jdataset.get_dataset("sample", str(jroot), split, jcfg)
        pds = pdataset.get_dataset("sample", str(proot), split, _port_cfg(jcfg))
        assert len(pds) == len(jds)
        for i in range(len(jds)):
            _assert_same(pds[i], jds[i], f"{split}[{i}]")
            _assert_same(pds[i], jds[i], f"{split}[{i}] warm")
    sidecars = sorted(p.name for p in jroot.rglob("*.npy"))
    assert sidecars == sorted(p.name for p in proot.rglob("*.npy")) and sidecars
    kinds = {n.split(".")[-2] for n in sidecars}
    assert kinds == {"aud16", "vid420" if fmt == "yuv420" else "vid"}
    jtrain = jdataset.get_dataset("sample", str(jroot), "train", jcfg)
    ptrain = pdataset.get_dataset("sample", str(proot), "train", _port_cfg(jcfg))
    assert len(ptrain) == 9
    jl, pl = (jdataset.create_dataloader(ds, 4, shuffle=True, seed=3) for ds in (jtrain, ptrain))
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(pb) == 3 and len(pb[-1]["sample_ids"]) == 4  # wrap-padded
        _assert_same(pb, jb, f"epoch {epoch}")


def test_cache_follows_the_media_mtime_and_missing_media_is_black(generated, tiny_config,
                                                                  tmp_path):
    root = tmp_path / "set"
    shutil.copytree(generated[0.0][0], root)
    cfg = _port_cfg(dataclasses.replace(tiny_config, video_wire_format="yuv420"))
    ds = pdataset.get_dataset("sample", str(root), "val", cfg)
    first = ds[0]
    row = ds.data[0]
    sidecar = root / (row["audio_path"] + ".aud16.npy")
    np.save(sidecar, np.ones_like(first["audio"]))
    os.utime(root / row["audio_path"], (1, 1))  # media older than the sidecar: cached
    assert (ds[0]["audio"] == 1).all()
    os.utime(root / row["audio_path"])  # media newer: decoded again
    np.testing.assert_array_equal(ds[0]["audio"], first["audio"])
    jds = jdataset.get_dataset("sample", str(root), "val",
                               dataclasses.replace(tiny_config, video_wire_format="yuv420"))
    for d in (ds, jds):
        d.data[0] = dict(row, audio_path="audio/none.wav", video_path="video/none.mp4")
    _assert_same(ds[0], jds[0])
    assert (ds[0]["video"][:, 32:] == 128).all() and (ds[0]["video"][:, :32] == 0).all()


def test_fewshot_indices_and_splits_match_jax(generated, tiny_config, tmp_path):
    root = generated[0.0][0]
    jds = jdataset.get_dataset("sample", root, "train", tiny_config)
    pds = pdataset.get_dataset("sample", root, "train", _port_cfg(tiny_config))
    for n_shot, seed in ((1, 42), (2, 7)):
        assert (pdataset.FewShotDataset(pds, n_shot, seed=seed).few_shot_indices
                == jdataset.FewShotDataset(jds, n_shot, seed=seed).few_shot_indices)
    labels = [r["emotion"] for r in jds.data] * 3
    for k in (2, 3):
        for (pt, pv), (jt, jv) in zip(splits.kfold_indices(labels, k, 5),
                                      jsplits.kfold_indices(labels, k, 5)):
            _assert_same((pt, pv), (jt, jv))
    _assert_same(splits.ratio_split(labels, 0.2, 0.1, 3), jsplits.ratio_split(labels, 0.2, 0.1, 3))
    combined = Path(root) / "train.csv"
    pdirs = splits.kfold_csvs(str(combined), str(tmp_path / "p"), 3, seed=1)
    jdirs = jsplits.kfold_csvs(str(combined), str(tmp_path / "j"), 3, seed=1)
    for pd_, jd_ in zip(pdirs, jdirs):
        for split in SPLITS:
            assert filecmp.cmp(Path(pd_) / f"{split}.csv", Path(jd_) / f"{split}.csv",
                               shallow=False)


# ---------------------------------------------------------------- tokenizer

PIECES = [("[PAD]", 0.0, CONTROL), ("[CLS]", 0.0, CONTROL), ("[SEP]", 0.0, CONTROL),
          ("[UNK]", 0.0, UNKNOWN), ("▁", -3.0, NORMAL), ("▁hello", -1.0, NORMAL),
          ("▁world", -1.5, NORMAL), ("▁hell", -1.25, NORMAL), ("o", -2.75, NORMAL),
          ("▁ab", -5.0, NORMAL), ("▁a", -1.0, NORMAL), ("b", -1.0, NORMAL),
          ("▁fi", -2.0, NORMAL)]


def test_spm_ids_match_jax(tmp_path):
    path = tmp_path / "spm.model"
    path.write_bytes(serialize_model_proto(PIECES))
    texts = ["hello world", "Hello   hellO", "ab fi ﬁ zz", "", "a b abab hello, world!"]
    pt = ptokenizer.get_tokenizer("microsoft/deberta-v3-base", 12, spm_path=str(path))
    jt = jtokenizer.get_tokenizer("microsoft/deberta-v3-base", 12, spm_path=str(path))
    assert isinstance(pt, ptokenizer.SpmTokenizer)
    for t in texts:
        assert pt.encode(t) == jt.encode(t), t
    _assert_same(pt(texts, max_length=12), jt(texts, max_length=12))


def test_get_tokenizer_falls_back_to_hash_with_one_warning(monkeypatch, capsys):
    monkeypatch.delenv("SMM_SPM_MODEL", raising=False)
    monkeypatch.setattr(ptokenizer, "_warned_fallback", False)
    a = ptokenizer.get_tokenizer("microsoft/deberta-v3-base", 16)
    b = ptokenizer.get_tokenizer("microsoft/deberta-v3-base", 16, spm_path="no/such.model")
    assert isinstance(a, ptokenizer.HashTokenizer) and isinstance(b, ptokenizer.HashTokenizer)
    err = capsys.readouterr().err
    assert err.count("WARNING") == 1 and "HashTokenizer" in err
    text = ["Tokenized the same way", "as the JAX package"]
    _assert_same(a(text, max_length=16), jtokenizer.HashTokenizer(model_max_length=16)(
        text, max_length=16))


# ------------------------------------------------------------------ metrics

def _metric_cases():
    rng = np.random.default_rng(4)
    cases = []
    for n, classes, tied in ((40, 7, False), (40, 7, True), (25, 4, False), (9, 1, False),
                             (30, 7, True)):
        t = rng.integers(0, classes, n)
        if classes == 7:
            t[:7] = np.arange(7)  # every class present
        p = np.where(rng.random(n) < 0.6, t, rng.integers(0, 7, n))
        logits = (rng.integers(0, 3, (n, 7)).astype(np.float64) if tied
                  else rng.standard_normal((n, 7)))
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        cases.append((t, p, probs))
    return cases


def _assert_close(a, b, where=""):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_close(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            _assert_close(x, y, where)
    elif a is None or b is None:
        assert a is None and b is None, (where, a, b)
    else:
        assert abs(a - b) <= 1e-12, (where, a, b)


@pytest.mark.parametrize("case", range(5))
def test_metrics_match_scikit_learn(case):
    """Absent classes (25 clips of 4 classes), ties (scores in three
    levels), one class only (ROC-AUC None), and the full case."""
    labels = ["happy", "sad", "angry", "fear", "surprise", "disgust", "neutral"]
    t, p, probs = _metric_cases()[case]
    want = jmetrics(t, p, probs, labels)
    got = calculate_metrics(t, p, probs, labels)
    _assert_close(got, want)
    assert (got["roc_auc"] is None) == (case in (2, 3))


# ----------------------------------------------------------------- pipeline

def test_prefetch_on_the_cpu_gives_tensors_and_reraises(generated, tiny_config):
    ds = pdataset.get_dataset("sample", generated[0.0][1], "val", _port_cfg(tiny_config))
    loader = pdataset.create_dataloader(ds, 2, shuffle=False)
    want = list(loader)
    got = list(pipeline.prefetch_to_device(loader, size=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["sample_ids"] == w["sample_ids"] and g["text_raw"] == w["text_raw"]
        assert isinstance(g["audio"], torch.Tensor)
        _assert_same({k: v.numpy() for k, v in g["text"].items()}, w["text"])
        _assert_same(g["video"].numpy(), w["video"])

    def broken():
        yield want[0]
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(pipeline.prefetch_to_device(broken(), device="cpu"))


def test_prefetch_stops_its_producer_when_the_consumer_stops():
    """A consumer that leaves early (the trainer's early stop, an error)
    must not leave the producer blocked on a full queue."""
    import threading

    before = set(threading.enumerate())
    produced = []

    def endless():
        while True:
            produced.append(1)
            yield {"emotion": np.zeros(2, np.int32), "sample_ids": [0, 1]}

    it = pipeline.prefetch_to_device(endless(), size=1, device="cpu")
    next(it)
    it.close()
    extra = [t for t in threading.enumerate() if t not in before]
    for t in extra:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in extra) and len(produced) >= 2


def test_device_cached_loader_draws_the_jax_permutation(generated, tiny_config):
    root = generated[0.0][0]
    jl = jdataset.create_dataloader(jdataset.get_dataset("sample", root, "train", tiny_config),
                                    4, seed=5)
    pl = pdataset.create_dataloader(
        pdataset.get_dataset("sample", root, "train", _port_cfg(tiny_config)), 4, seed=5)
    jc = jpipeline.DeviceCachedLoader(jl, seed=5)
    pc = pipeline.DeviceCachedLoader(pl, device="cpu", seed=5)
    assert len(pc) == len(jc) == 3
    for epoch in (0, 1):
        jc.set_epoch(epoch)
        pc.set_epoch(epoch)
        for jb, pb in zip(jc, pc):
            assert pb["sample_ids"] == jb["sample_ids"]
            np.testing.assert_array_equal(pb["video"].numpy(), np.asarray(jb["video"]))
            np.testing.assert_array_equal(pb["text"]["input_ids"].numpy(),
                                          np.asarray(jb["text"]["input_ids"]))
    batch = next(iter(pl))
    assert pipeline.estimate_batch_bytes(batch) == jpipeline.estimate_batch_bytes(batch)
