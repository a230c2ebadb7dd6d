#!/usr/bin/env python
"""Interactive demo server of the PyTorch port (beside ``demo/serve.py``).

The same dependency-free stdlib HTTP server as ``demo/serve.py``: the
browser UI (text box, audio/video upload and webcam capture, emotion
distribution and valence-arousal charts, the AI response, activity
suggestions, the conversation history) at ``GET /`` and the JSON API
``POST /api/analyze`` (a JSON body with media paths confined to
``--media_dir``, or multipart with uploaded bytes), on port 7860. ``--cli``
runs one request from the command line without the server. It serves the
port's ``MultimodalEmotionDemo`` from a port checkpoint directory.

Runs on the card: ``--device`` defaults to ``cuda`` and raises without a
CUDA device; ``--device cpu`` serves from the CPU.

    python demo/serve_torch.py --model_path checkpoints/final_model_hierarchical
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAGE = """<!DOCTYPE html>
<html>
<head>
<title>🎭 Multimodal Emotion Recognition</title>
<style>
 body { font-family: Arial, sans-serif; margin: 30px; background:#fafafa; }
 .card { background:white; border:1px solid #ddd; border-radius:8px;
         padding:20px; margin:15px 0; }
 textarea { width:100%; height:70px; }
 .bar { height:22px; margin:3px 0; color:#222; padding-left:6px;
        white-space:nowrap; }
 #va { position:relative; width:320px; height:320px; border:1px solid #ccc;
       background:linear-gradient(to top, #f8f8ff, #fff); }
 .anchor { position:absolute; width:14px; height:14px; border-radius:50%;
           transform:translate(-50%,-50%); opacity:.65; }
 .pred { position:absolute; width:18px; height:18px; background:red;
         transform:translate(-50%,-50%) rotate(45deg); border:2px solid black; }
 .label { position:absolute; font-size:11px; transform:translate(-50%,-160%); }
 pre { white-space: pre-wrap; }
</style>
</head>
<body>
<h1>🎭 Multimodal Emotion Recognition (PyTorch port)</h1>
<div class="card">
  <h3>Input</h3>
  <textarea id="text" placeholder="How are you feeling today?"></textarea><br/>
  Audio (wav): <input type="file" id="audio" accept=".wav"/><br/>
  Video (mp4): <input type="file" id="video" accept=".mp4,.avi,.mov"/><br/>
  <div style="margin-top:8px">
    Webcam: <button id="camStart" onclick="camStart()">Start recording</button>
    <button id="camStop" onclick="camStop()" disabled>Stop</button>
    <span id="camStatus"></span><br/>
    <video id="camPreview" width="240" autoplay muted playsinline
           style="display:none; margin-top:6px; border:1px solid #ccc"></video>
  </div><br/>
  <button onclick="analyze()">Analyze Emotion</button>
</div>
<div class="card"><h3>Emotion Distribution</h3><div id="dist"></div></div>
<div class="card"><h3>Valence-Arousal Space</h3><div id="va"></div></div>
<div class="card"><h3>AI Response</h3><pre id="resp"></pre></div>
<div class="card"><h3>Suggestions</h3><pre id="sugg"></pre></div>
<div class="card"><h3>Conversation History</h3><pre id="hist"></pre></div>
<script>
// Webcam capture: getUserMedia preview + MediaRecorder -> webm blob,
// uploaded as the 'webcam_video' field (the reference demo's webcam input,
// gradio_demo.py:613-616, served here without gradio).
let camStream = null, camRecorder = null, camBlob = null, camChunks = [];
async function camStart() {
  try {
    camStream = await navigator.mediaDevices.getUserMedia({video: true});
  } catch (e) {
    document.getElementById('camStatus').textContent = 'camera unavailable: ' + e;
    return;
  }
  const prev = document.getElementById('camPreview');
  prev.srcObject = camStream; prev.style.display = 'block';
  camChunks = []; camBlob = null;
  camRecorder = new MediaRecorder(camStream, {mimeType: 'video/webm'});
  camRecorder.ondataavailable = (e) => { if (e.data.size) camChunks.push(e.data); };
  camRecorder.onstop = () => {
    camBlob = new Blob(camChunks, {type: 'video/webm'});
    document.getElementById('camStatus').textContent =
      'clip ready (' + (camBlob.size/1024).toFixed(0) + ' KB)';
  };
  camRecorder.start();
  document.getElementById('camStart').disabled = true;
  document.getElementById('camStop').disabled = false;
  document.getElementById('camStatus').textContent = 'recording…';
}
function camStop() {
  if (camRecorder && camRecorder.state !== 'inactive') camRecorder.stop();
  if (camStream) camStream.getTracks().forEach(t => t.stop());
  document.getElementById('camPreview').style.display = 'none';
  document.getElementById('camStart').disabled = false;
  document.getElementById('camStop').disabled = true;
}
async function analyze() {
  const fd = new FormData();
  fd.append('text', document.getElementById('text').value);
  const a = document.getElementById('audio').files[0];
  const v = document.getElementById('video').files[0];
  if (a) fd.append('audio', a);
  if (v) fd.append('video', v);
  if (camBlob) fd.append('webcam_video', camBlob, 'webcam.webm');
  document.getElementById('resp').textContent = 'Analyzing...';
  const res = await fetch('/api/analyze', {method:'POST', body: fd});
  const data = await res.json();
  render(data);
}
function render(d) {
  if (d.error) { document.getElementById('resp').textContent = d.error; return; }
  const dist = document.getElementById('dist'); dist.innerHTML='';
  const c = d.emotion_chart;
  c.labels.forEach((lab,i)=>{
    const v = c.values[i];
    const div = document.createElement('div');
    div.className='bar';
    div.style.width = Math.max(3, v*100*5)+'px';
    div.style.background = c.colors[i];
    div.textContent = lab+' '+(v*100).toFixed(1)+'%';
    dist.appendChild(div);
  });
  const va = document.getElementById('va'); va.innerHTML='';
  const toPx = (x)=> (x+1)/2*320;
  Object.entries(d.va_chart.anchors).forEach(([emo,a])=>{
    const el=document.createElement('div'); el.className='anchor';
    el.style.left=toPx(a.valence)+'px'; el.style.top=(320-toPx(a.arousal))+'px';
    el.style.background=a.color; va.appendChild(el);
    const lb=document.createElement('div'); lb.className='label';
    lb.style.left=toPx(a.valence)+'px'; lb.style.top=(320-toPx(a.arousal))+'px';
    lb.textContent=emo; va.appendChild(lb);
  });
  const p=d.va_chart.prediction;
  const el=document.createElement('div'); el.className='pred';
  el.title='Predicted: '+p.emotion;
  el.style.left=toPx(Math.max(-1,Math.min(1,p.valence)))+'px';
  el.style.top=(320-toPx(Math.max(-1,Math.min(1,p.arousal))))+'px';
  va.appendChild(el);
  document.getElementById('resp').textContent = d.ai_response;
  document.getElementById('sugg').textContent = d.suggestions;
  document.getElementById('hist').textContent = d.history.map(
    h=>`[${h.timestamp}] (${h.emotion} ${(h.confidence*100).toFixed(0)}%) ${h.user_input}\\n  → ${h.ai_response}`
  ).join('\\n\\n');
}
</script>
</body>
</html>"""


def _parse_multipart(body: bytes, content_type: str):
    """Parse a multipart/form-data body into {name: (filename, bytes)}.

    Stdlib-only via the email package (the cgi module is removed in
    Python 3.13, and pyproject allows >=3.10).
    """
    import email.parser
    import email.policy

    head = f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n"
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        head.encode() + body
    )
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True) or b""
        fields[name] = (part.get_filename(), payload)
    return fields


def _resolve_media_path(path, media_dir):
    """Confine client-supplied file paths to the configured media directory
    (a remote client must not be able to read arbitrary host files)."""
    if not path:
        return None
    resolved = os.path.realpath(os.path.join(media_dir, path))
    if os.path.commonpath([resolved, os.path.realpath(media_dir)]) != \
            os.path.realpath(media_dir):
        raise ValueError(f"Path escapes media directory: {path}")
    return resolved


def make_handler(demo, media_dir="."):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("[demo]", fmt % args)

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.end_headers()
            self.wfile.write(PAGE.encode())

        def do_POST(self):
            if self.path != "/api/analyze":
                self.send_response(404)
                self.end_headers()
                return
            ctype = self.headers.get("Content-Type", "")
            text, audio_path, video_path, webcam_path = "", None, None, None
            tmpfiles = []
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if ctype.startswith("multipart/form-data"):
                    form = _parse_multipart(raw, ctype)
                    if "text" in form:
                        text = form["text"][1].decode("utf-8", "replace")
                    saved = {}
                    for field, suffix in (("audio", ".wav"),
                                          ("video", ".mp4"),
                                          ("webcam_video", ".webm")):
                        filename, payload = form.get(field, (None, b""))
                        if filename and payload:
                            f = tempfile.NamedTemporaryFile(
                                suffix=suffix, delete=False)
                            f.write(payload)
                            f.close()
                            tmpfiles.append(f.name)
                            saved[field] = f.name
                    audio_path = saved.get("audio")
                    video_path = saved.get("video")
                    webcam_path = saved.get("webcam_video")
                else:
                    body = json.loads(raw or b"{}")
                    text = body.get("text", "")
                    # JSON paths are confined to --media_dir; remote clients
                    # should upload raw bytes via multipart instead
                    audio_path = _resolve_media_path(
                        body.get("audio_path"), media_dir)
                    video_path = _resolve_media_path(
                        body.get("video_path"), media_dir)
                    webcam_path = _resolve_media_path(
                        body.get("webcam_path"), media_dir)

                analysis, response, suggestions, chart, va = (
                    demo.process_multimodal_input(
                        text, audio_path, video_path,
                        webcam_video=webcam_path)
                )
                payload = {
                    "emotion_analysis": analysis,
                    "ai_response": response,
                    "suggestions": suggestions,
                    "emotion_chart": chart,
                    "va_chart": va,
                    "history": demo.conversation_history[-10:],
                }
                if not analysis:
                    payload["error"] = response
                out = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(out)
            except Exception as e:
                self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({"error": str(e)}).encode())
            finally:
                for p in tmpfiles:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

    return Handler


def load_demo(model_path: str, config_path=None, device="cuda"):
    """The port's demo over a checkpoint directory; ``config_path`` (a
    JSON file, with or without a ``model_config`` key) overrides the
    checkpoint's config."""
    from simple_multimodal_tpu_torch.config import (ModelConfig, config_from_dict,
                                                    load_config_json)
    from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo

    config = None
    if config_path:
        data = load_config_json(config_path)
        config = config_from_dict(ModelConfig, data.get("model_config", data))
    return MultimodalEmotionDemo(config=config, checkpoint_path=model_path, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Multimodal emotion demo (PyTorch port)")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--cli", action="store_true",
                        help="One-shot CLI analysis instead of serving")
    parser.add_argument("--media_dir", type=str, default=".",
                        help="Directory JSON-API media paths are confined to")
    parser.add_argument("--text", type=str, default="")
    parser.add_argument("--audio", type=str, default=None)
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default): the card, raising without one; cpu: the CPU")
    args = parser.parse_args(argv)

    demo = load_demo(args.model_path, args.config_path, args.device)

    if args.cli:
        analysis, response, suggestions, chart, va = (
            demo.process_multimodal_input(args.text, args.audio, args.video)
        )
        print(json.dumps({
            "emotion_analysis": analysis,
            "ai_response": response,
            "suggestions": suggestions,
        }, indent=2))
        return

    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(
        (args.host, args.port), make_handler(demo, media_dir=args.media_dir))
    print(f"Demo running at http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
