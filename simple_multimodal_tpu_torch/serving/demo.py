"""Serving core: per-request inference + emotion-aware responses (port of
simple_multimodal_tpu/serving/demo.py).

``MultimodalEmotionDemo`` holds a port model on an explicit device, built
from a model + config or loaded from a port checkpoint (``save_checkpoint``:
a ``torch.save`` of the state_dict and the config as JSON).
``predict(text, audio, video)`` runs one request and raises on error;
``process_multimodal_input`` is the UI entry point and, like the
reference, turns any error into an error tuple. Audio and video arrive as
already decoded arrays (or None, meaning zeros); decoding files waits for
the host data path (ROADMAP Queue 1, 'Host data path'). The response templates,
activity suggestions and chart payloads are pure Python.
"""
import json
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, config_from_dict, config_to_dict
from ..data.tokenizer import get_tokenizer
from ..models.multimodal_model import MultimodalEmotionModel
from ..ops.attention import resolve_dtype

EMOTION_COLORS = {
    "happy": "#FFD700", "sad": "#4169E1", "angry": "#DC143C",
    "fear": "#9932CC", "surprise": "#FF69B4", "disgust": "#228B22",
    "neutral": "#808080",
}

# Approximate anchor coordinates of each emotion in valence-arousal space.
VALENCE_AROUSAL_ANCHORS = {
    "happy": (0.8, 0.6), "surprise": (0.4, 0.8), "angry": (-0.6, 0.7),
    "fear": (-0.6, 0.8), "sad": (-0.7, -0.4), "disgust": (-0.6, 0.2),
    "neutral": (0.0, 0.0),
}

ACTIVITY_SUGGESTIONS = {
    "happy": [
        "🎉 Celebrate with the people around you!",
        "📸 Save this moment — a photo or a few journal lines",
        "🎵 Put on something upbeat and move a little",
        "🌟 Point this energy at a creative project",
        "💝 Pass the good mood along with a kind gesture",
    ],
    "sad": [
        "🤗 Check in with someone you trust",
        "📖 Pick up a comforting book or something uplifting to watch",
        "🚶 Take an easy walk outside",
        "🎨 Let the feeling out through writing or art",
        "☕ Make a warm drink and be gentle with yourself",
    ],
    "angry": [
        "🧘 Slow your breathing for a couple of minutes",
        "🏃 Burn the edge off with some exercise",
        "📝 Put the frustration into words on paper",
        "🎵 Queue up something calming",
        "💬 Tell someone you trust what set you off",
    ],
    "fear": [
        "🛡️ Name the parts of the situation you can control",
        "🧘 Ground yourself (try the 5-4-3-2-1 senses check)",
        "💪 Split the scary thing into small steps",
        "🤝 Lean on friends, family, or a professional",
        "📚 Learn more about what is driving the worry",
    ],
    "surprise": [
        "🤔 Give yourself a beat to take it in",
        "📝 Jot down your first reactions",
        "💬 Tell someone close what just happened",
        "🎯 Think through what changes because of it",
        "🌟 Treat the unexpected as room to grow",
    ],
    "disgust": [
        "🚿 Step away from whatever is unpleasant if you can",
        "🧘 Notice the feeling without judging it",
        "🌿 Reset with something cleansing — a shower, a tidy space",
        "💭 Ask what value this reaction is protecting",
        "🎯 Turn attention toward a positive alternative",
    ],
    "neutral": [
        "🎯 A calm moment — good time to set a goal",
        "📚 Learn something new or revisit a hobby",
        "🤝 Reach out to friends or family",
        "🌟 Try an activity you have not done before",
        "🧘 A few minutes of mindfulness never hurts",
    ],
}


class EmotionAwareResponseGenerator:
    """Template-based empathetic responses with a keyword context slot."""

    RESPONSE_TEMPLATES = {
        "happy": [
            "That's great to hear — your happiness really shows. {context}",
            "I can feel the joy in this! {context}",
            "Your positive energy comes through clearly. {context}",
        ],
        "sad": [
            "It sounds like things are heavy right now. {context} It's okay to feel this way.",
            "I'm picking up some sadness here. {context} Your feelings are valid.",
            "That sounds hard. {context} I'm here to listen if you want to say more.",
        ],
        "angry": [
            "I can tell this is frustrating. {context} Anger is an understandable response.",
            "The frustration comes through. {context} Maybe we can work through it together.",
            "I hear how upset you are. {context} What might help right now?",
        ],
        "fear": [
            "There seems to be some worry in what you're sharing. {context} Feeling scared is natural.",
            "It sounds like this is making you anxious. {context} You're not alone in that.",
            "I sense some concern here. {context} Want to talk through what's worrying you?",
        ],
        "surprise": [
            "That sounds unexpected! {context} How are you taking it in?",
            "That must have caught you off guard. {context} Surprises can be a lot.",
            "Quite a turn of events! {context} What happens next?",
        ],
        "disgust": [
            "Something clearly isn't sitting right with you. {context} That reaction makes sense.",
            "That does sound unpleasant. {context} It's fair to feel put off.",
            "I can tell this bothers you. {context} Sometimes things just feel wrong.",
        ],
        "neutral": [
            "Thanks for sharing that. {context} How can I help today?",
            "Got it. {context} What would you like to look into next?",
            "Interesting. {context} What are your thoughts on it?",
        ],
    }

    CONTEXT_RULES = (
        (("work", "job", "boss", "colleague"),
         "Work situations can really shape how we feel."),
        (("family", "parent", "child", "sibling"),
         "Family relationships matter a lot to our wellbeing."),
        (("friend", "friendship"),
         "Friendships play a big role in our lives."),
        (("school", "study", "exam", "test"),
         "Academic pressure can be intense."),
    )

    FOLLOW_UPS = {
        "happy": "What's been the best part of your day?",
        "sad": "Is something specific weighing on you?",
        "angry": "What do you think would help you feel better?",
        "fear": "Would you like to talk about what's making you anxious?",
        "surprise": "How do you think this changes things for you?",
        "disgust": "What would help you move past this feeling?",
        "neutral": "What's on your mind today?",
    }

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def _context(self, user_input: str) -> str:
        words = set((user_input or "").lower().split())
        for keywords, context in self.CONTEXT_RULES:
            if words & set(keywords):
                return context
        return "Life has its ups and downs."

    def _follow_up(self, emotion: str, confidence: float) -> str:
        if confidence < 0.6:
            return ("I'm not fully sure I've read your emotional state right — "
                    "how are you really feeling?")
        return self.FOLLOW_UPS.get(emotion, "How can I support you better?")

    def generate_response(self, user_input: str, emotion: str,
                          confidence: float, emotion_analysis: Dict) -> str:
        templates = self.RESPONSE_TEMPLATES.get(emotion, self.RESPONSE_TEMPLATES["neutral"])
        response = self._rng.choice(templates).format(context=self._context(user_input))
        return response + " " + self._follow_up(emotion, confidence)


def activity_suggestions(emotion: str, confidence: float) -> str:
    """Confidence-tiered suggestion text."""
    suggestions = ACTIVITY_SUGGESTIONS.get(emotion, ACTIVITY_SUGGESTIONS["neutral"])
    if confidence > 0.8:
        msg = f"I'm quite confident ({confidence:.1%}) that you're feeling {emotion}."
    elif confidence > 0.6:
        msg = f"I think ({confidence:.1%} confidence) you might be feeling {emotion}."
    else:
        msg = (f"I'm not entirely sure, but you might be feeling {emotion} "
               f"({confidence:.1%} confidence).")
    return msg + "\n\nHere are some suggestions:\n\n" + "\n".join(suggestions[:3])


def save_checkpoint(path: str, model: MultimodalEmotionModel, config) -> None:
    """A port checkpoint: the state_dict and the config as JSON."""
    torch.save({"state_dict": model.state_dict(),
                "config": json.dumps(config_to_dict(config))}, path)


def load_checkpoint(path: str, device="cpu", config=None) -> Tuple[MultimodalEmotionModel, object]:
    """(model, config) from ``save_checkpoint``'s file, on ``device``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if config is None:
        config = config_from_dict(ModelConfig, json.loads(payload["config"]))
    model = MultimodalEmotionModel(config, dtype=resolve_dtype(config, device))
    model.load_state_dict(payload["state_dict"])
    return model.to(device).eval(), config


class MultimodalEmotionDemo:
    """Serves per-request emotion analysis from a port model."""

    def __init__(self, model: Optional[MultimodalEmotionModel] = None, config=None,
                 checkpoint_path: Optional[str] = None, device="cpu"):
        self.device = torch.device(device)
        if checkpoint_path is not None:
            model, config = load_checkpoint(checkpoint_path, self.device, config)
        elif model is None:
            raise ValueError("MultimodalEmotionDemo needs a model or a checkpoint_path")
        self.config = config if config is not None else model.config
        self.model = model.to(self.device).eval()
        self.tokenizer = get_tokenizer(self.config.text_model_name,
                                       self.config.text_max_length,
                                       spm_path=getattr(self.config, "spm_model_path", None))
        self.emotion_colors = dict(EMOTION_COLORS)
        self.conversation_history: List[Dict] = []
        self.response_generator = EmotionAwareResponseGenerator()

    # ------------------------------------------------------------ preprocess
    def _process_text(self, text: str) -> Dict[str, torch.Tensor]:
        enc = self.tokenizer([text or ""], max_length=self.config.text_max_length)
        return {k: torch.from_numpy(v).to(self.device) for k, v in enc.items()}

    @staticmethod
    def _no_files(value, what: str):
        if isinstance(value, (str, bytes)) or hasattr(value, "__fspath__"):
            raise NotImplementedError(
                f"{what} files are not decoded by the port yet (ROADMAP Queue 1, "
                f"'Host data path'): pass the decoded array instead")

    def _process_audio(self, audio) -> torch.Tensor:
        """None → zeros; an array [T] or [1, T] (float or int16) as given."""
        self._no_files(audio, "audio")
        if audio is None:
            audio = np.zeros((self.config.audio_max_length,), np.float32)
        audio = np.asarray(audio)
        return torch.from_numpy(audio.reshape(1, -1)).to(self.device)

    def _process_video(self, video) -> torch.Tensor:
        """None → zeros; a decoded clip [T, H, W, 3] (uint8 or float) or a
        packed yuv420 clip [T, H*3//2, W], with or without a batch of 1."""
        self._no_files(video, "video")
        if video is None:
            w, h = tuple(self.config.video_frame_size)
            video = np.zeros((self.config.video_max_frames, h, w, 3), np.uint8)
        video = np.asarray(video)
        packed = video.dtype == np.uint8 and video.shape[-1] != 3
        if video.ndim == (3 if packed else 4):
            video = video[None]
        return torch.from_numpy(np.ascontiguousarray(video)).to(self.device)

    def prepare(self, text: str, audio=None, video=None) -> Tuple:
        """One request's model inputs (text dict, audio, video) on the device."""
        return (self._process_text(text), self._process_audio(audio),
                self._process_video(video))

    # -------------------------------------------------------------- inference
    @torch.inference_mode()
    def forward(self, text: str, audio=None, video=None) -> Dict:
        """The model's raw output dict for one request."""
        return self.model(*self.prepare(text, audio, video))

    def predict(self, text_input: str, audio=None, video=None) -> Dict:
        """One request → the emotion analysis dict. Raises on any error."""
        outputs = self.forward(text_input, audio, video)
        probs = outputs["emotion_probs"][0].float().cpu().numpy()
        labels = self.config.emotion_labels
        predicted = labels[int(np.argmax(probs))]
        return {
            "predicted_emotion": predicted,
            "confidence": float(np.max(probs)),
            "emotion_distribution": {e: float(p) for e, p in zip(labels, probs)},
            "individual_modalities": {},
            "valence": float(outputs["valence"][0, 0]),
            "arousal": float(outputs["arousal"][0, 0]),
        }

    def process_multimodal_input(self, text_input: str, audio=None, video=None,
                                 webcam_video=None) -> Tuple:
        """UI entry point: (analysis, response, suggestions, emotion chart,
        valence-arousal chart), or an error tuple — never raises."""
        try:
            analysis = self.predict(text_input, audio,
                                    webcam_video if webcam_video is not None else video)
            predicted, confidence = analysis["predicted_emotion"], analysis["confidence"]
            ai_response = self.response_generator.generate_response(
                text_input, predicted, confidence, analysis)
            suggestions = activity_suggestions(predicted, confidence)
            emotion_chart = self.emotion_chart_data(analysis["emotion_distribution"])
            va_chart = self.valence_arousal_chart_data(analysis["valence"],
                                                       analysis["arousal"], predicted)
            self.conversation_history.append({
                "user_input": text_input, "emotion": predicted,
                "confidence": confidence, "ai_response": ai_response,
                "timestamp": time.strftime("%H:%M:%S"),
            })
            return analysis, ai_response, suggestions, emotion_chart, va_chart
        except Exception as e:  # the UI boundary keeps serving
            return ({}, f"Error processing input: {e}",
                    "Please try again with valid inputs.", None, None)

    # ----------------------------------------------------------------- charts
    def emotion_chart_data(self, distribution: Dict[str, float]) -> Dict:
        return {
            "type": "bar",
            "title": "Emotion Distribution",
            "labels": list(distribution.keys()),
            "values": list(distribution.values()),
            "colors": [self.emotion_colors.get(e, "#808080") for e in distribution],
        }

    def valence_arousal_chart_data(self, valence: float, arousal: float,
                                   emotion: str) -> Dict:
        return {
            "type": "scatter",
            "title": "Valence-Arousal Space",
            "anchors": {
                e: {"valence": v, "arousal": a, "color": self.emotion_colors.get(e, "#808080")}
                for e, (v, a) in VALENCE_AROUSAL_ANCHORS.items()
            },
            "prediction": {"valence": valence, "arousal": arousal, "emotion": emotion},
        }
