"""B=1 requests through the port's demo (``MultimodalEmotionDemo.predict``,
built around the model so that no checkpoint is written), served one at a
time as the demo serves. Without ``rate_per_s`` in the traffic file one
client sends them in a closed loop, each request when the previous answer
has come, for the whole window; with it the requests are offered in an open
loop: request k is due at k / rate seconds into the window and starts when
it is due and the previous one has finished. A latency runs from when the
request was due to the returned analysis, so a stall counts against the
requests it holds up. Each request carries text, int16 audio and RGB uint8
frames, as a user of the demo sends a clip.

Set-up serves every request of the pool once, so every audio length the
window uses has run before it. After the window the reference answers a
sample of the window's requests, drawn from the seed with the longest
request in it, and each is compared with the answer the window returned.
"""
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import clips, compare, flops, harness, weights
from portbench.reference import frozen
from portbench.reference import model as ref


def run(ctx):
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    config = ctx.program_config()
    model = create_model(config, "standard", device=dev)
    model.load_state_dict(weights.make(ref.spec(cfg), ctx.seed, dev))
    demo = MultimodalEmotionDemo(model=model, config=config, device=dev)
    if ctx.patch:
        demo = ctx.patch("demo", demo)
    reqs = clips.requests(cfg, tr, ctx.seed)
    for r in reqs:
        demo.predict(*r)
    rng = np.random.default_rng([ctx.seed, 4])

    def cycle():  # every request once in each round, rounds in orders drawn from the seed
        while True:
            yield from (int(i) for i in rng.permutation(len(reqs)))

    order = cycle()
    ctx.reset_peak()
    ctx.setup_done()

    lat, service, answers, failed = [], [], [], 0
    rate = tr.get("rate_per_s")
    t0 = time.perf_counter()
    k = 0
    while (k < int(ctx.seconds * rate)) if rate else (time.perf_counter() - t0 < ctx.seconds):
        if rate:
            due = t0 + k / rate
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        else:
            due = time.perf_counter()
        k += 1
        i = next(order)
        t = time.perf_counter()
        try:
            with record_function("portbench.predict"):
                a = demo.predict(*reqs[i])
            answers.append((i, a))
        except Exception as e:  # a failed request counts against the attempted
            failed += 1
            ctx.info.append(f"request {i} failed: {e!r}")
        done = time.perf_counter()
        lat.append(done - due)
        service.append(done - t)
    ctx.window_s = time.perf_counter() - t0
    ctx.latencies, ctx.service = lat, service
    ctx.attempted, ctx.failed = len(lat), failed
    per_req = [flops.forward(cfg, samples=len(reqs[i][1]))["total"] for i in range(len(reqs))]
    ctx.flops_done = sum(per_req[i] for i, _ in answers)
    ctx.work = {"per_request": per_req}
    q = np.percentile(np.asarray(lat) * 1e3, [0, 10, 50, 90, 95, 100])
    late = np.asarray(lat) - np.asarray(service)
    thirds = np.array_split(np.asarray(service) * 1e3, 3)
    offered = f"due at {rate}/s" if rate else "from one client in a closed loop"
    ctx.info.append(f"serve window: {len(lat)} requests {offered} ({failed} failed) "
                    f"in {ctx.window_s!r} s; {sum(1 for x in lat if x > np.percentile(lat, 95))} "
                    f"beyond the p95; latency ms at 0/10/50/90/95/100%: {np.round(q, 3).tolist()}; "
                    f"service mean {1e3 * np.mean(service):.3f} ms (thirds of the window "
                    f"{', '.join(f'{t.mean():.3f}' for t in thirds)}); started late (queued) "
                    f"{int((late > 1e-3).sum())} requests, at most {1e3 * late.max():.3f} ms")

    if ctx.tracing:
        def one():
            with record_function("portbench.predict"):
                demo.predict(*reqs[next(order)])

        harness.profile_segment(ctx, one, tr["traced_requests"])
    ctx.read_peak()
    ctx.card_line()
    del demo, model
    ctx.free()

    longest = max(range(len(reqs)), key=lambda i: len(reqs[i][1]))
    done = [k for k, (i, _) in enumerate(answers)]
    picks = list(rng.choice(done, min(tr["checked"], len(done)), replace=False))
    picks += [k for k, (i, _) in enumerate(answers) if i == longest][:1]
    P = weights.make(ref.spec(cfg), ctx.seed, dev)
    prog, want = [], []
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for k in picks:
                i, a = answers[k]
                text, audio, video = reqs[i]
                ids, mask = (torch.from_numpy(x)[None].to(dev)
                             for x in frozen.tokenize(text, cfg["program"]["text_max_length"]))
                wav = torch.from_numpy(audio.astype(np.float32) / 32768.0)[None].to(dev)
                frames = torch.from_numpy(video)[None].to(dev).float() / 255.0
                o = ref.forward(ref.Run(), P, cfg, ids, mask, wav, frames)
                want.append({"probs": o["probs"][0].tolist(), "valence": float(o["valence"][0]),
                             "arousal": float(o["arousal"][0])})
                prog.append({"probs": list(a["emotion_distribution"].values()),
                             "valence": a["valence"], "arousal": a["arousal"]})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    numbers, info = compare.serve(prog, want)
    ctx.info += info
    for name, value in numbers.items():
        ctx.check(name, value)
    ctx.decide()
