"""The one traffic generator: clips and requests from a traffic file's
parameters and the run's seed.

Every seed gets the same set of sizes (word counts, clip lengths) spread
evenly over the file's ranges, in an order and with contents drawn from the
seed, so that seeds change what is computed on, not how much.
"""
import math

import numpy as np
import torch


def _grid(lo, hi, n, rng):
    """n values spread evenly over [lo, hi], in an order drawn from rng."""
    return rng.permutation(np.round(np.linspace(lo, hi, n)).astype(np.int64))


def _rng(seed, stream):
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def train_pool(cfg, traffic, seed, device):
    """A pool of clips on the device, as the trainer's device cache holds a
    small set: token ids and mask [N, S], int16 audio [N, T], packed yuv420
    video [N, F, H·3/2, W] and labels [N]."""
    pc = cfg["program"]
    n, S, T = traffic["pool"], pc["text_max_length"], pc["audio_max_length"]
    frames, (H, W) = pc["video_max_frames"], pc["video_frame_size"]
    rng = _rng(seed, 1)
    words = _grid(*traffic["words"], n, rng)
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    ids = torch.randint(100, cfg["text"]["vocab_size"], (n, S), generator=g, device=device)
    lengths = torch.as_tensor(np.minimum(words + 2, S), device=device)
    pos = torch.arange(S, device=device)[None]
    mask = (pos < lengths[:, None]).long()
    ids = torch.where(pos == 0, 1, ids)
    ids = torch.where(pos == lengths[:, None] - 1, 2, ids) * mask
    audio = _tones(n, T, pc.get("audio_sample_rate", 16000), g, device)
    video = torch.randint(0, 256, (n, frames, H * 3 // 2, W), generator=g, device=device,
                          dtype=torch.uint8)
    labels = torch.randint(0, pc["num_emotions"], (n,), generator=g, device=device)
    return {"input_ids": ids.to(torch.int32), "attention_mask": mask.to(torch.int32),
            "audio": audio, "video": video, "emotion": labels}


def _tones(n, T, rate, g, device):
    """int16 clips: a tone of 80-400 Hz at 0.05-0.4 of full scale plus noise."""
    t = torch.arange(T, device=device, dtype=torch.float32) / rate
    f = 80.0 + 320.0 * torch.rand((n, 1), generator=g, device=device)
    amp = 0.05 + 0.35 * torch.rand((n, 1), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((n, 1), generator=g, device=device)
    x = amp * torch.sin(2 * math.pi * f * t + phase)
    x = x + 0.02 * torch.randn((n, T), generator=g, device=device)
    return (x.clamp(-1.0, 1.0) * 32767.0).round().to(torch.int16)


def take(pool, rows):
    """The batch of ``rows`` (a host array), gathered on the device."""
    idx = torch.as_tensor(rows, device=pool["emotion"].device)
    text = {k: pool[k].index_select(0, idx) for k in ("input_ids", "attention_mask")}
    return {"text": text, **{k: pool[k].index_select(0, idx) for k in ("audio", "video", "emotion")}}


def train_rows(traffic, seed):
    """(first, rest): the rows of the checked steps, all different, and an
    endless iterator of the rows of every later step."""
    n, B, checked = traffic["pool"], traffic["batch"], traffic["checked_steps"]
    rng = _rng(seed, 2)
    perm = rng.permutation(n)
    first = [perm[i * B:(i + 1) * B] for i in range(checked)]

    def rest():
        while True:
            yield rng.choice(n, B, replace=False)

    return first, rest()


def requests(cfg, traffic, seed):
    """Serving requests: (text, int16 audio [T], RGB uint8 video [F, H, W, 3])."""
    pc = cfg["program"]
    n, rate = traffic["pool"], pc.get("audio_sample_rate", 16000)
    frames, (H, W) = pc["video_max_frames"], pc["video_frame_size"]
    rng = _rng(seed, 3)
    words = _grid(*traffic["words"], n, rng)
    lo, hi = traffic["audio_seconds"]
    lengths = _grid(lo * rate, hi * rate, n, rng)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for i in range(n):
        text = " ".join("".join(rng.choice(letters, rng.integers(2, 10)))
                        for _ in range(words[i]))
        T = int(lengths[i])
        t = np.arange(T) / rate
        x = rng.uniform(0.05, 0.4) * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                                            + rng.uniform(0, 2 * np.pi))
        x = x + 0.02 * rng.standard_normal(T)
        audio = (np.clip(x, -1, 1) * 32767).round().astype(np.int16)
        video = rng.integers(0, 256, (frames, H, W, 3), dtype=np.uint8)
        out.append((text, audio, video))
    return out
