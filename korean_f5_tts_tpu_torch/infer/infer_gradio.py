"""Gradio web UI: basic TTS / multi-speech-type / voice-chat tabs
(counterpart of korean_f5_tts_tpu/infer/infer_gradio.py).

    python -m korean_f5_tts_tpu_torch.infer.infer_gradio [--device cpu]

Parity with reference `src/f5_tts/infer/infer_gradio.py` (3 tabs at
`:216,395,751`, custom model loader `:77-96`, cached infer `:131-215`).
gradio is imported inside `build_app` only (utils/gradio_stub.py stands in
for it where it is absent); the tab logic (speech-type tag parser,
synthesize_segments, VoiceChatSession pipeline) is importable and tested
without it. The model and the vocoder live on `device`, the card unless the
caller names the CPU, with fp32 weights (load_model without a dtype, as the
JAX app), so synthesis runs the fp32 forms of kernels A, B and C. The
voice-chat tab's LLM backend loads any local transformers causal-LM
checkpoint (imported when asked for; reference hardcodes Qwen2.5-3B +
downloads Whisper; zero-egress builds inject backends).
"""

from __future__ import annotations

import functools
import json
import re

from korean_f5_tts_tpu_torch.utils.misc import require_device

DEFAULT_TTS_MODEL = "F5TTS_v1_Base"

# reference infer_gradio.py:455 — per-type rows pre-built, shown on demand
MAX_SPEECH_TYPES = 100


def parse_speechtypes_text(gen_text: str) -> list[dict]:
    """Split speech-type-tagged script into segments.

    Reference contract (infer_gradio.py:361-392): a tag is either `{Name}`
    or a JSON dict `{"name": str, "seed": int, "speed": float}`; the current
    tag applies until the next one; untagged leading text is `Regular` with
    seed -1 (random) and speed 1.0.
    """
    tokens = re.split(r"(\{.*?\})", gen_text)
    segments = []
    current = {"name": "Regular", "seed": -1, "speed": 1.0}
    for i, token in enumerate(tokens):
        if i % 2 == 0:
            text = token.strip()
            if text:
                segments.append({**current, "text": text})
        else:
            try:
                current = json.loads(token.strip())
                current.setdefault("name", "Regular")
                current.setdefault("seed", -1)
                current.setdefault("speed", 1.0)
            except json.JSONDecodeError:
                current = {"name": token.strip()[1:-1], "seed": -1,
                           "speed": 1.0}
    return segments


def load_text_from_file(file) -> str:
    """.txt upload -> textbox value (reference infer_gradio.py:123-130)."""
    if not file:
        return ""
    with open(file, encoding="utf-8") as f:
        return f.read().strip()


def strip_long_silences(wav, sr: int):
    """In-memory remove_silence_for_generated_wav (utils_infer.py:784-793 —
    the reference roundtrips through a temp file; same span parameters)."""
    from korean_f5_tts_tpu_torch.utils import audio as audio_utils

    if wav is None:
        return wav
    import numpy as np

    mono = audio_utils.to_mono(np.asarray(wav))
    spans = audio_utils.split_on_silence_spans(
        mono, sr, min_silence_ms=1000, silence_threshold_db=-50.0,
        keep_silence_ms=500)
    return np.concatenate([mono[s:e] for s, e in spans]) if spans else mono


@functools.lru_cache(maxsize=4)
def _load_model_cached(model_name: str, ckpt_file: str, vocab_file: str,
                       tokenizer: str, device="cuda"):
    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model

    return load_model(preset_model_config(model_name),
                      ckpt_path=ckpt_file or None, vocab_file=vocab_file or None,
                      tokenizer=tokenizer or None, device=device)


def synthesize_segments(segments: list[dict], voices: dict[str, dict], model_obj,
                        vocoder, nfe_step: int = 32, **kw):
    """Render tagged segments with per-type reference audio, concatenated.

    Per-segment seed/speed follow the reference's multistyle generate loop
    (infer_gradio.py:653-700): seed -1 draws a fresh random seed, and the
    resolved value is reported back for the cherry-pick panel. Returns
    (wav, sr, used) where used lists {name, seed, speed, text} per segment.
    """
    import numpy as np

    from korean_f5_tts_tpu_torch.infer.utils_infer import infer_process

    out, used = [], []
    sr = 24_000
    for seg in segments:
        name = seg.get("name", seg.get("style", "Regular"))
        v = voices.get(name, voices.get("Regular"))
        if v is None:
            continue
        seed = int(seg.get("seed", -1))
        if seed < 0:
            seed = int(np.random.randint(0, 2**31 - 1))
        speed = float(seg.get("speed", 1.0))
        wav, sr, _ = infer_process(
            (v["ref_wav"], v["sr"]), v["ref_text"], seg["text"], model_obj,
            vocoder, nfe_step=nfe_step, show_info=lambda *a: None,
            seed=seed, speed=speed, **kw,
        )
        out.append(wav)
        used.append({"name": name, "seed": seed, "speed": speed,
                     "text": seg["text"]})
    return (np.concatenate(out) if out else None), sr, used


def chat_model_inference(messages: list[dict], model, tokenizer,
                         max_new_tokens: int = 512, temperature: float = 0.7,
                         top_p: float = 0.95) -> str:
    """Chat-template generation with a transformers causal LM — the exact
    contract of the reference's Qwen2.5 path (infer_gradio.py:99-119)."""
    text = tokenizer.apply_chat_template(
        messages, tokenize=False, add_generation_prompt=True)
    inputs = tokenizer([text], return_tensors="pt").to(model.device)
    generated = model.generate(**inputs, max_new_tokens=max_new_tokens,
                               temperature=temperature, top_p=top_p)
    trimmed = [out[len(inp):] for inp, out in zip(inputs.input_ids, generated)]
    return tokenizer.batch_decode(trimmed, skip_special_tokens=True)[0]


def make_hf_chat_backend(model_name: str = "Qwen/Qwen2.5-3B-Instruct"):
    """messages -> reply via a local HF checkpoint (download/path required;
    zero-egress builds inject their own backend into VoiceChatSession)."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    model = AutoModelForCausalLM.from_pretrained(model_name, torch_dtype="auto",
                                                 device_map="auto")
    tokenizer = AutoTokenizer.from_pretrained(model_name)
    return lambda messages: chat_model_inference(messages, model, tokenizer)


class VoiceChatSession:
    """Voice-chat tab core (reference infer_gradio.py:751-961), UI-free.

    Pipeline per user turn: audio/text in -> ASR (set_asr_backend or typed
    text) -> chat LLM (injectable `chat_fn(messages) -> str`) -> TTS of the
    assistant reply in the reference voice. Conversation state is the
    message list the reference keeps in the gr.Chatbot.
    """

    DEFAULT_SYSTEM_PROMPT = (
        "You are not an AI assistant, you are whoever the user says you are. "
        "You must stay in character. Keep your responses concise since they "
        "will be spoken out loud."
    )

    def __init__(self, chat_fn, model_obj=None, vocoder=None,
                 system_prompt: str | None = None):
        self.chat_fn = chat_fn
        self.model_obj = model_obj
        self.vocoder = vocoder
        self.system_prompt = system_prompt or self.DEFAULT_SYSTEM_PROMPT
        self.conversation: list[dict] = []

    def process_audio_input(self, audio_path: str | None, text: str = "") -> str | None:
        """User turn: transcribe the clip (or take typed text) and append
        (infer_gradio.py:863-877)."""
        if audio_path:
            from korean_f5_tts_tpu_torch.infer.utils_infer import preprocess_ref_audio_text

            text = preprocess_ref_audio_text(audio_path, text)[1]
        if not (text or "").strip():
            return None
        self.conversation.append({"role": "user", "content": text})
        return text

    def generate_text_response(self) -> str:
        """Assistant turn via the chat backend (infer_gradio.py:879-891)."""
        messages = [{"role": "system", "content": self.system_prompt}]
        messages += self.conversation
        reply = self.chat_fn(messages)
        self.conversation.append({"role": "assistant", "content": reply})
        return reply

    def generate_audio_response(self, ref_audio, ref_text: str,
                                seed: int | None = None, nfe_step: int = 32):
        """TTS of the last assistant reply in the reference voice
        (infer_gradio.py:893-917). Returns (wav, sr) or None."""
        if not self.conversation or self.conversation[-1]["role"] != "assistant":
            return None
        if self.model_obj is None:
            return None
        from korean_f5_tts_tpu_torch.infer.utils_infer import infer_process

        wav, sr, _ = infer_process(
            ref_audio, ref_text, self.conversation[-1]["content"],
            self.model_obj, self.vocoder, nfe_step=nfe_step,
            show_info=lambda *a: None, seed=seed,
        )
        return wav, sr

    def clear(self) -> None:
        self.conversation = []


def build_app(model_name: str = DEFAULT_TTS_MODEL, ckpt_file: str = "",
              vocab_file: str = "", tokenizer: str = "", device="cuda"):
    """Construct the gradio Blocks app (requires gradio or
    utils/gradio_stub.py's stand-in); the model and the vocoder on `device`."""
    device = require_device(device)
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "gradio is not installed in this image; the inference UI requires it. "
            "Use korean_f5_tts_tpu_torch.infer.cli or the HTTP server instead."
        ) from e

    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.infer.utils_infer import infer_process, preprocess_ref_audio_text

    model_obj = _load_model_cached(model_name, ckpt_file, vocab_file, tokenizer, device)
    vocoder = load_vocoder("vocos", device=device)

    def basic_tts(ref_audio, ref_text, gen_text, remove_silence, cross_fade,
                  nfe_step, speed):
        audio, ref_text = preprocess_ref_audio_text(ref_audio, ref_text)
        wav, sr, spec = infer_process(
            audio, ref_text, gen_text, model_obj, vocoder,
            cross_fade_duration=cross_fade, nfe_step=int(nfe_step), speed=speed,
        )
        if remove_silence:
            wav = strip_long_silences(wav, sr)
        return (sr, wav)

    with gr.Blocks(title="Korean F5-TTS (PyTorch/CUDA)") as app:
        gr.Markdown("# Korean F5-TTS — PyTorch/CUDA port")
        with gr.Tab("Basic TTS"):
            ref_audio = gr.Audio(label="Reference audio", type="filepath")
            ref_text = gr.Textbox(label="Reference text")
            gen_text = gr.Textbox(label="Text to generate", lines=4)
            with gr.Accordion("Advanced", open=False):
                remove_silence = gr.Checkbox(label="Remove silences", value=False)
                cross_fade = gr.Slider(0.0, 1.0, 0.15, label="Cross-fade (s)")
                nfe = gr.Slider(4, 64, 32, step=2, label="NFE steps")
                speed = gr.Slider(0.3, 2.0, 1.0, label="Speed")
            btn = gr.Button("Synthesize", variant="primary")
            out = gr.Audio(label="Output")
            btn.click(basic_tts,
                      [ref_audio, ref_text, gen_text, remove_silence, cross_fade,
                       nfe, speed], out)
        with gr.Tab("Multi-Speech-Type"):
            # reference infer_gradio.py:395-749: one mandatory Regular row +
            # pre-built hidden rows shown/hidden by Add/Delete, per-row
            # name/audio/ref-text/seed/speed/txt-loader, insert-label buttons
            # that bake the row's settings into a JSON tag, and a cherry-pick
            # panel listing the seed each segment actually used.
            gr.Markdown("Tag segments as `{Name}` or "
                        '`{"name": ..., "seed": ..., "speed": ...}`; '
                        "add one reference per speech type below.")
            st_rows, st_names, st_audios, st_ref_texts = [], [], [], []
            st_ref_files, st_seeds, st_speeds = [], [], []
            st_delete_btns, st_insert_btns = [], []
            for i in range(MAX_SPEECH_TYPES):
                regular = i == 0
                with gr.Row(variant="compact", visible=regular) as row:
                    with gr.Column(scale=1, min_width=160):
                        name_in = gr.Textbox(
                            label="Speech Type Name",
                            value="Regular" if regular else None)
                        insert_btn = gr.Button("Insert Label",
                                               variant="secondary")
                        delete_btn = (None if regular else
                                      gr.Button("Delete Type", variant="stop"))
                    with gr.Column(scale=3):
                        audio_in = gr.Audio(label="Reference Audio",
                                            type="filepath")
                    with gr.Column(scale=3):
                        ref_text_in = gr.Textbox(label="Reference Text", lines=4)
                        with gr.Row():
                            seed_in = gr.Slider(
                                -1, 999, -1, step=1, show_label=False,
                                info="Seed, -1 for random")
                            speed_in = gr.Slider(
                                0.3, 2.0, 1.0, step=0.1, show_label=False,
                                info="Adjust the speed")
                    with gr.Column(scale=1, min_width=160):
                        ref_file_in = gr.File(
                            label="Load Reference Text from File (.txt)",
                            file_types=[".txt"])
                st_rows.append(row)
                st_names.append(name_in)
                st_audios.append(audio_in)
                st_ref_texts.append(ref_text_in)
                st_ref_files.append(ref_file_in)
                st_seeds.append(seed_in)
                st_speeds.append(speed_in)
                st_delete_btns.append(delete_btn)
                st_insert_btns.append(insert_btn)
                # clearing the audio clears its ref text + file
                audio_in.clear(lambda: [None, None], None,
                               [ref_text_in, ref_file_in])
                ref_file_in.upload(load_text_from_file, [ref_file_in],
                                   [ref_text_in])

            add_btn = gr.Button("Add Speech Type")
            st_count = gr.State(1)

            def add_speech_type(count):
                updates = [gr.update() for _ in range(MAX_SPEECH_TYPES)]
                if count < MAX_SPEECH_TYPES:
                    updates[count] = gr.update(visible=True)
                    count += 1
                else:
                    gr.Warning("Exhausted maximum number of speech types.")
                return [count] + updates

            add_btn.click(add_speech_type, [st_count], [st_count] + st_rows)

            def delete_speech_type():
                return gr.update(visible=False), None, None, None, None

            for i in range(1, MAX_SPEECH_TYPES):
                st_delete_btns[i].click(
                    delete_speech_type,
                    outputs=[st_rows[i], st_names[i], st_audios[i],
                             st_ref_texts[i], st_ref_files[i]])

            with gr.Row():
                multi_text = gr.Textbox(
                    label="Text to Generate", lines=10, scale=4,
                    placeholder="{Regular} Hello. {Shouting} HEY!")
                multi_text_file = gr.File(
                    label="Load Text to Generate from File (.txt)",
                    file_types=[".txt"], scale=1)
            multi_text_file.upload(load_text_from_file, [multi_text_file],
                                   [multi_text])

            def make_insert_fn(index):
                def insert_fn(current_text, name, seed, speed):
                    current_text = current_text or ""
                    if not name:
                        gr.Warning("Please enter speech type name before insert.")
                        return current_text
                    tag = json.dumps({"name": name, "seed": int(seed),
                                      "speed": float(speed)})
                    return current_text + tag + " "
                return insert_fn

            for i, btn_i in enumerate(st_insert_btns):
                btn_i.click(make_insert_fn(i),
                            [multi_text, st_names[i], st_seeds[i], st_speeds[i]],
                            multi_text)

            with gr.Accordion("Advanced Settings", open=True):
                with gr.Row():
                    show_cherrypick = gr.Checkbox(
                        label="Show Cherry-pick Interface", value=False,
                        info="Show the seeds previous generations used.")
                    remove_silence_multi = gr.Checkbox(
                        label="Remove Silences", value=True)
                    multi_nfe = gr.Slider(4, 64, 32, step=2, label="NFE steps")

            generate_multi_btn = gr.Button("Generate Multi-Style Speech",
                                           variant="primary")
            multi_out = gr.Audio(label="Synthesized Audio")
            cherrypick_box = gr.Textbox(label="Cherry-pick Interface",
                                        lines=10, interactive=False,
                                        visible=False)
            show_cherrypick.change(lambda vis: gr.update(visible=vis),
                                   show_cherrypick, cherrypick_box)

            def multi_tts(script, nfe_step, remove_silence, *flat):
                from korean_f5_tts_tpu_torch.utils.audio import load_wav, to_mono

                n = MAX_SPEECH_TYPES
                names, audios, texts = flat[:n], flat[n:2 * n], flat[2 * n:3 * n]
                voices = {}
                for name, path, rtext in zip(names, audios, texts):
                    if not (name and path):
                        continue
                    wav, sr = load_wav(path)
                    voices[name.strip()] = {"ref_wav": to_mono(wav), "sr": sr,
                                            "ref_text": rtext or ""}
                segments = parse_speechtypes_text(script)
                missing = {s["name"] for s in segments} - set(voices)
                if missing:
                    gr.Warning(f"No reference audio for type(s): {missing}")
                wav, sr, used = synthesize_segments(
                    segments, voices, model_obj, vocoder,
                    nfe_step=int(nfe_step))
                if remove_silence:
                    wav = strip_long_silences(wav, sr)
                lines = "\n".join(
                    f'{{"name": "{u["name"]}", "seed": {u["seed"]}, '
                    f'"speed": {u["speed"]}}} {u["text"]}' for u in used)
                return (sr, wav), lines

            generate_multi_btn.click(
                multi_tts,
                [multi_text, multi_nfe, remove_silence_multi]
                + st_names + st_audios + st_ref_texts,
                [multi_out, cherrypick_box])
        with gr.Tab("Voice Chat"):
            gr.Markdown("Have a conversation with an AI using your reference "
                        "voice. Requires a local chat LLM checkpoint "
                        "(e.g. Qwen/Qwen2.5-3B-Instruct) and an ASR backend.")
            chat_model_name = gr.Textbox(label="Chat model (HF name or path)",
                                         value="Qwen/Qwen2.5-3B-Instruct")
            load_chat_btn = gr.Button("Load chat model", variant="primary")
            chat_status = gr.Markdown("*no chat model loaded*")
            chat_ref_audio = gr.Audio(label="Reference audio", type="filepath")
            chat_ref_text = gr.Textbox(label="Reference text")
            system_prompt = gr.Textbox(label="System prompt",
                                       value=VoiceChatSession.DEFAULT_SYSTEM_PROMPT,
                                       lines=2)
            chatbot = gr.Chatbot(label="Conversation", type="messages")
            chat_text = gr.Textbox(label="Type your message")
            chat_audio_in = gr.Microphone(label="Or speak", type="filepath")
            chat_out = gr.Audio(label="AI voice reply", autoplay=True)
            clear_btn = gr.Button("Clear conversation")
            session_state = gr.State(None)

            def load_chat(name, prompt):
                session = VoiceChatSession(
                    make_hf_chat_backend(name), model_obj=model_obj,
                    vocoder=vocoder, system_prompt=prompt)
                return session, f"chat model `{name}` loaded"

            def chat_turn(session, audio_path, text, ref_audio_path, ref_text_v):
                if session is None:
                    return session, [], None
                if session.process_audio_input(audio_path, text) is None:
                    return session, list(session.conversation), None
                session.generate_text_response()
                out = None
                if ref_audio_path:
                    res = session.generate_audio_response(ref_audio_path,
                                                          ref_text_v)
                    if res is not None:
                        wav, sr = res
                        out = (sr, wav)
                return session, list(session.conversation), out

            def clear_chat(session):
                if session is not None:
                    session.clear()
                return session, [], None

            load_chat_btn.click(load_chat, [chat_model_name, system_prompt],
                                [session_state, chat_status])
            for trigger in (chat_text.submit, chat_audio_in.stop_recording):
                trigger(chat_turn,
                        [session_state, chat_audio_in, chat_text,
                         chat_ref_audio, chat_ref_text],
                        [session_state, chatbot, chat_out])
            clear_btn.click(clear_chat, [session_state],
                            [session_state, chatbot, chat_out])
    return app


def main(argv=None):  # pragma: no cover
    import argparse

    p = argparse.ArgumentParser(prog="python -m korean_f5_tts_tpu_torch.infer.infer_gradio")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--share", action="store_true")
    p.add_argument("--model", default=DEFAULT_TTS_MODEL)
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    app = build_app(args.model, args.ckpt_file, args.vocab_file,
                    device=require_device(args.device))
    app.queue().launch(server_name=args.host, server_port=args.port,
                       share=args.share)


if __name__ == "__main__":
    main()
