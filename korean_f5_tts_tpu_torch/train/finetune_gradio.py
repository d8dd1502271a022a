"""Finetuning studio: project management, data prep, training control, test
inference (counterpart of korean_f5_tts_tpu/train/finetune_gradio.py).

    python -m korean_f5_tts_tpu_torch.train.finetune_gradio [--device cpu]

Parity with reference `src/f5_tts/train/finetune_gradio.py`: project dirs
(`data/<project>/...`), audio slicing (`:181-296` -> utils/slicer.py),
transcription (`:619-689`, gated offline), metadata -> arrow (`:728-838` ->
train/datasets/prepare.py), vocab check/extend (`:957-1062` ->
train/vocab_extend.py), training via a spawned
`korean_f5_tts_tpu_torch.train.finetune_cli` process with kill/restart
(`:326-450`, `:584-593`), checkpoint pruning (`:932-955`), resource stats
(`:1269-1348`). The functional core below is importable and tested without
gradio; `build_app` imports gradio (or utils/gradio_stub.py's stand-in) and
builds the UI. The project, the child and the test inference run on
`device`: the card unless the caller names the CPU.
"""

from __future__ import annotations

import json
import os
import shlex
import signal
import subprocess
import sys

import torch

from korean_f5_tts_tpu_torch.utils.misc import require_device

# the directory that holds this package: the child process imports the same copy
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class FinetuneProject:
    """Filesystem layout + training-process lifecycle for one project."""

    def __init__(self, name: str, root: str = "data", device="cuda"):
        self.name = name
        self.root = root
        self.device = require_device(device)
        self.dir = os.path.join(root, f"{name}_pinyin")
        self.wavs_dir = os.path.join(self.dir, "wavs")
        self.ckpt_dir = os.path.join("ckpts", name)
        self._proc: subprocess.Popen | None = None

    def create(self) -> str:
        os.makedirs(self.wavs_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        return self.dir

    # -- data prep ----------------------------------------------------------

    def slice_audio(self, wav_path: str, **slicer_kwargs) -> list[str]:
        import numpy as np

        from korean_f5_tts_tpu_torch.utils.audio import load_wav, save_wav, to_mono
        from korean_f5_tts_tpu_torch.utils.slicer import Slicer

        wav, sr = load_wav(wav_path)
        mono = to_mono(np.asarray(wav))
        clips = Slicer(sr, **slicer_kwargs).slice(mono)
        base = os.path.splitext(os.path.basename(wav_path))[0]
        out = []
        for i, clip in enumerate(clips):
            path = os.path.join(self.wavs_dir, f"{base}_{i:04d}.wav")
            save_wav(path, clip, sr)
            out.append(path)
        return out

    def transcribe_all(self, transcribe_fn=None) -> str:
        """Write metadata.csv from wavs via an injected ASR (offline-gated)."""
        if transcribe_fn is None:
            raise RuntimeError(
                "transcription needs an ASR backend (Whisper weights are not "
                "downloadable offline); write metadata.csv manually or pass "
                "transcribe_fn"
            )
        rows = []
        for f in sorted(os.listdir(self.wavs_dir)):
            if f.endswith(".wav"):
                rows.append(f"{f}|{transcribe_fn(os.path.join(self.wavs_dir, f))}")
        meta = os.path.join(self.dir, "metadata.csv")
        with open(meta, "w", encoding="utf-8") as fh:
            fh.write("\n".join(rows))
        return meta

    def prepare_arrow(self, tokenizer: str = "char", **kw) -> str:
        from korean_f5_tts_tpu_torch.train.datasets.prepare import prepare

        return prepare(self.dir, self.name, tokenizer, corpus_format="csv",
                       data_dir=self.root, **kw)

    # -- training process (finetune_gradio.py:326-450 role) -----------------

    def start_training(self, exp_name: str = "F5TTS_v1_Base", extra_args: str = "",
                       tokenizer: str = "char") -> int:
        """Start the port's finetune_cli on this project's device as a child in
        a session of its own; the child imports this copy of the package,
        whatever the working directory."""
        if self.is_training():
            raise RuntimeError("training already running")
        cmd = (
            f"{shlex.quote(sys.executable)} -m korean_f5_tts_tpu_torch.train.finetune_cli "
            f"--exp_name {exp_name} --dataset_name {self.name} "
            f"--tokenizer {tokenizer} --device {self.device} {extra_args}"
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
        self._proc = subprocess.Popen(
            shlex.split(cmd), start_new_session=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        return self._proc.pid

    def is_training(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def stop_training(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
        self._proc = None

    # -- checkpoints --------------------------------------------------------

    def prune_checkpoint(self, step: int | str = "last") -> str:
        from korean_f5_tts_tpu_torch.train.vocab_extend import prune_checkpoint

        src = os.path.join(self.ckpt_dir, f"model_{step}.npz")
        dst = os.path.join(self.ckpt_dir, f"model_{step}_pruned.npz")
        prune_checkpoint(src, dst)
        return dst


def _meminfo_gb() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in GB (empty where the
    file is absent)."""
    try:
        with open("/proc/meminfo") as f:
            mem = dict(line.split(":")[0:1] + [line.split()[1]] for line in f
                       if line.startswith(("MemTotal", "MemAvailable")))
    except OSError:
        return {}
    return {"mem_total_gb": round(int(mem.get("MemTotal", 0)) / 1e6, 1),
            "mem_available_gb": round(int(mem.get("MemAvailable", 0)) / 1e6, 1)}


def system_stats() -> dict:
    """CPU/memory (+ CUDA device list) snapshot (finetune_gradio:1269-1348 role)."""
    stats = _meminfo_gb()
    try:
        with open("/proc/loadavg") as f:
            stats["loadavg"] = f.read().split()[0]
    except OSError:
        pass
    stats["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    return stats


def get_accelerator_stats() -> str:
    """Per-card report (reference finetune_gradio.py:1269-1320 get_gpu_stats):
    name, total and free memory (`torch.cuda.mem_get_info`), this process's
    allocated and peak allocated memory. Without a card the report says so."""
    if not torch.cuda.is_available():
        return "No CUDA device (torch.cuda.is_available() is false)"
    lines = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        lines.append(f"Device {i} Name: {torch.cuda.get_device_name(i)}")
        lines.append(f"Total memory (device {i}): {total / 1024**3:.2f} GB")
        lines.append(f"Free memory (device {i}): {free / 1024**3:.2f} GB")
        lines.append(f"Allocated memory (device {i}): "
                     f"{torch.cuda.memory_allocated(i) / 1024**2:.2f} MB")
        lines.append(f"Peak allocated memory (device {i}): "
                     f"{torch.cuda.max_memory_allocated(i) / 1024**2:.2f} MB")
        lines.append("")
    return "\n".join(lines).strip()


def get_cpu_stats() -> str:
    """CPU/memory report (reference finetune_gradio.py:1323-1340, psutil-free:
    /proc is read where it exists)."""
    s = system_stats()
    used = s.get("mem_total_gb", 0.0) - s.get("mem_available_gb", 0.0)
    return (f"CPU load (1 min): {s.get('loadavg', '?')}\n"
            f"System Memory: {used:.1f} GB used / "
            f"{s.get('mem_total_gb', 0.0):.1f} GB total")


def get_combined_stats() -> str:
    """### GPU/### CPU combined panel text (finetune_gradio.py:1343-1347)."""
    return (f"### Accelerator Stats\n{get_accelerator_stats()}\n\n"
            f"### CPU Stats\n{get_cpu_stats()}")


def device_memory_gb(device="cuda") -> float:
    """The memory calculate_train sizes the frame batch from: the card's total
    memory in GiB (`torch.cuda.get_device_properties`, as the reference's
    studio reads it), or on the CPU the system memory available, as the
    reference's studio does for unified memory."""
    device = require_device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 1024**3
    return _meminfo_gb().get("mem_available_gb", 0.0)


# ---------------------------------------------------------------------------
# settings persistence (finetune_gradio.py:61-173)
# ---------------------------------------------------------------------------

# the JAX package's defaults, kept so that a setting.json reads the same in both
DEFAULT_SETTINGS = {
    "exp_name": "F5TTS_v1_Base",
    "learning_rate": 1e-5,
    "batch_size_per_gpu": 9600,
    "batch_size_type": "frame",
    "max_samples": 64,
    "grad_accumulation_steps": 1,
    "max_grad_norm": 1.0,
    "epochs": 100,
    "num_warmup_updates": 100,
    "save_per_updates": 500,
    "keep_last_n_checkpoints": -1,
    "last_per_updates": 100,
    "finetune": True,
    "file_checkpoint_train": "",
    "tokenizer_type": "kor_grapheme",
    "tokenizer_file": "",
    "mixed_precision": "bf16",
    "logger": "tensorboard",
}


def _settings_path(project_name: str, ckpt_root: str = "ckpts") -> str:
    base = project_name.replace("_pinyin", "").replace("_char", "")
    return os.path.join(ckpt_root, base, "setting.json")


def save_settings(project_name: str, settings: dict, ckpt_root: str = "ckpts") -> str:
    """Persist per-project training settings (finetune_gradio.py:61-110)."""
    path = _settings_path(project_name, ckpt_root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    merged = {**DEFAULT_SETTINGS, **settings}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=4)
    return "Settings saved!"


def load_settings(project_name: str, ckpt_root: str = "ckpts") -> dict:
    """Defaults overlaid with the project's setting.json (:114-173)."""
    settings = dict(DEFAULT_SETTINGS)
    path = _settings_path(project_name, ckpt_root)
    if os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            settings.update(json.load(f))
    return settings


def format_seconds_to_hms(seconds: float) -> str:
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


# ---------------------------------------------------------------------------
# training-parameter suggestion (finetune_gradio.py:843-929)
# ---------------------------------------------------------------------------

HOP_LENGTH = 256
SAMPLING_RATE = 24_000
MAX_UPDATES = 1_200_000


def calculate_train(
    project_dir: str,
    batch_size_type: str = "frame",
    max_samples: int = 64,
    num_warmup_updates: int = 100,
    finetune: bool = True,
    gpu_memory_gb: float = 80.0,
    n_chips: int = 1,
) -> dict:
    """Suggest epochs/lr/batch from the project's duration.json (:843-929).

    The frame batch comes from the card's memory with the reference's
    formula for its CUDA studio, 38400 * (gpu_memory_gb - 5) / 75 frames
    (build_app passes device_memory_gb). Epochs
    are capped at 1.2M total updates, warmup floors at 5% of samples.
    """
    file_duration = os.path.join(project_dir, "duration.json")
    if not os.path.isfile(file_duration):
        return {"error": "project not found !"}
    with open(file_duration, encoding="utf-8") as f:
        duration_list = json.load(f)["duration"]

    max_sample_length = max(duration_list) * SAMPLING_RATE / HOP_LENGTH
    total_samples = len(duration_list)
    total_duration = sum(duration_list)

    if batch_size_type == "frame":
        batch_size_per_gpu = max(int(38400 * (gpu_memory_gb - 5) / 75),
                                 int(max_sample_length))
        mini_batch_duration = batch_size_per_gpu * n_chips * HOP_LENGTH / SAMPLING_RATE
        updates_per_epoch = total_duration / mini_batch_duration
    else:  # sample
        batch_size_per_gpu = int(200 / (total_duration / total_samples))
        updates_per_epoch = total_samples / max(batch_size_per_gpu, 1) / n_chips

    if total_samples < 64:
        max_samples = int(total_samples * 0.25)
    num_warmup_updates = max(num_warmup_updates, int(total_samples * 0.05))
    epochs = int(MAX_UPDATES / max(updates_per_epoch, 1e-9))
    learning_rate = 1e-5 if finetune else 7.5e-5

    return {
        "epochs": epochs,
        "learning_rate": learning_rate,
        "batch_size_per_gpu": batch_size_per_gpu,
        "max_samples": max_samples,
        "num_warmup_updates": num_warmup_updates,
        "total_samples": total_samples,
        "total_duration_hms": format_seconds_to_hms(total_duration),
    }


# ---------------------------------------------------------------------------
# vocab check + project/sample browsing (finetune_gradio.py:997-1160,1214-1267)
# ---------------------------------------------------------------------------


def vocab_count(text: str) -> int:
    return len(text.split(","))


def vocab_check(project_dir: str, vocab_file: str,
                tokenizer_type: str = "kor_grapheme") -> tuple[str, str]:
    """Scan metadata.csv for symbols missing from the vocab (:1064-1108)."""
    file_metadata = os.path.join(project_dir, "metadata.csv")
    if not os.path.isfile(vocab_file):
        return f"the file {vocab_file} not found !", ""
    if not os.path.isfile(file_metadata):
        return f"the file {file_metadata} not found !", ""
    with open(vocab_file, encoding="utf-8-sig") as f:
        vocab = set(f.read().split("\n"))

    from korean_f5_tts_tpu_torch.text.vocab import tokenize_text

    miss, seen = [], set()
    with open(file_metadata, encoding="utf-8-sig") as f:
        for line in f:
            sp = line.rstrip("\n").split("|")
            if len(sp) != 2:
                continue
            tokens = tokenize_text([sp[1].strip()], tokenizer_type, vocab={"": 0}
                                   if tokenizer_type != "pinyin" else None)[0]
            for t in tokens:
                if t not in vocab and t not in seen:
                    miss.append(t)
                    seen.add(t)
    if not miss:
        return "You can train using your language !", ""
    return (f"The following {len(miss)} symbols are missing in your language\n\n",
            ",".join(miss))


def get_list_projects(root: str = "data") -> list[str]:
    """Project dirs under data/ (finetune_gradio.py:595-608)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        if os.path.isdir(os.path.join(root, name)) and (
            name.endswith("_pinyin") or name.endswith("_char")
            or os.path.exists(os.path.join(root, name, "metadata.csv"))
        ):
            out.append(name)
    return out


def get_checkpoints_project(project_name: str, ckpt_root: str = "ckpts") -> list[str]:
    """Sorted checkpoint files for the test-model tab (:1214-1245)."""
    base = project_name.replace("_pinyin", "").replace("_char", "")
    d = os.path.join(ckpt_root, base)
    if not os.path.isdir(d):
        return []
    files = [f for f in os.listdir(d) if f.endswith((".npz", ".pt", ".safetensors"))]

    def step_of(f):
        digits = "".join(c for c in f if c.isdigit())
        return int(digits) if digits else -1

    return [os.path.join(d, f) for f in sorted(files, key=step_of)]


def get_audio_project(project_dir: str) -> list[str]:
    wavs = os.path.join(project_dir, "wavs")
    if not os.path.isdir(wavs):
        return []
    return [os.path.join(wavs, f) for f in sorted(os.listdir(wavs))
            if f.endswith(".wav")]


def get_random_sample_transcribe(project_dir: str, seed: int | None = None):
    """(text, audio_path) drawn from metadata.csv (:1124-1150)."""
    import random as _random

    meta = os.path.join(project_dir, "metadata.csv")
    if not os.path.isfile(meta):
        return "", None
    rows = []
    with open(meta, encoding="utf-8-sig") as f:
        for line in f:
            sp = line.rstrip("\n").split("|")
            if len(sp) == 2:
                rows.append(sp)
    if not rows:
        return "", None
    name, text = _random.Random(seed).choice(rows)
    audio = os.path.join(project_dir, "wavs", name)
    if not audio.endswith(".wav"):
        audio += ".wav"
    return text, audio


def get_random_sample_prepare(project_dir: str, seed: int | None = None):
    """(token-list string, audio_path) from the prepared arrow (:1111-1121)."""
    import random as _random

    from korean_f5_tts_tpu_torch.data.dataset import _read_arrow_rows

    arrow = os.path.join(project_dir, "raw.arrow")
    if not os.path.isfile(arrow):
        return "", None
    rows = _read_arrow_rows(arrow)
    if not rows:
        return "", None
    row = _random.Random(seed).choice(rows)
    toks = row["text"] if isinstance(row["text"], list) else list(row["text"])
    return "[" + " , ".join(f"' {t} '" for t in toks) + "]", row.get("audio_path")


def test_model_infer(ckpt_path: str, ref_audio: str, ref_text: str, gen_text: str,
                     exp_name: str = "F5TTS_v1_Base", tokenizer: str = "custom",
                     vocab_file: str = "", nfe_step: int = 32, speed: float = 1.0,
                     seed: int | None = None, device="cuda", kernels: bool = True):
    """Test-model tab core (:1162-1208): load ckpt + zero-shot synth, on
    `device` with fp32 weights (load_model without a dtype, as JAX), through
    the kernels unless kernels=False."""
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.infer.utils_infer import (
        infer_process,
        preprocess_ref_audio_text,
    )

    model = load_model(preset_model_config(exp_name), ckpt_path=ckpt_path or None,
                       tokenizer=tokenizer, vocab_file=vocab_file or None, device=device)
    vocoder = load_vocoder("vocos", device=device)
    ref_audio, ref_text = preprocess_ref_audio_text(ref_audio, ref_text,
                                                    show_info=lambda *a: None)
    wav, sr, _ = infer_process(ref_audio, ref_text, gen_text, model, vocoder,
                               nfe_step=nfe_step, speed=speed, seed=seed,
                               show_info=lambda *a: None, kernels=kernels)
    return sr, wav


def build_app(device="cuda"):
    """The studio's gradio Blocks (requires gradio or utils/gradio_stub.py's
    stand-in): projects, slicing, test inference and the training child run
    on `device`."""
    device = require_device(device)
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this image; use FinetuneProject "
            "programmatically or korean_f5_tts_tpu_torch.train.finetune_cli"
        ) from e

    projects = get_list_projects() or ["my_speak_pinyin"]

    def _project(name):
        return FinetuneProject(name.replace("_pinyin", "").replace("_char", ""), device=device)

    with gr.Blocks(title="F5-TTS finetune studio (PyTorch/CUDA)") as app:
        gr.Markdown("# Finetune studio")
        with gr.Row():
            project = gr.Dropdown(choices=projects, value=projects[0],
                                  label="Project", allow_custom_value=True)
            btn_create = gr.Button("Create / refresh")
        status = gr.Textbox(label="Status")

        def _create(name):
            proj = _project(name)
            proj.create()
            return gr.update(choices=get_list_projects() or [name]), f"ready: {proj.dir}"

        btn_create.click(_create, project, [project, status])

        def _dir(name):
            p = _project(name)
            return p.dir if os.path.isdir(p.dir) else os.path.join("data", name)

        with gr.Tabs():
            with gr.TabItem("Transcribe Data"):
                gr.Markdown("Upload long audio; it is sliced into clips. "
                            "Transcription needs an ASR backend "
                            "(set_asr_backend) — offline images write "
                            "metadata.csv manually.")
                audio_in = gr.File(label="Audio files", file_count="multiple")
                out_slices = gr.Textbox(label="Slices")

                def _slice(name, files):
                    proj = _project(name)
                    proj.create()
                    done = []
                    for f in files or []:
                        done += proj.slice_audio(f.name if hasattr(f, "name") else f)
                    return "\n".join(done) or "no files"

                gr.Button("Slice").click(_slice, [project, audio_in], out_slices)
                t_text = gr.Textbox(label="Random transcribed sample")
                t_audio = gr.Audio(label="Audio", type="filepath")
                gr.Button("Random sample").click(
                    lambda n: get_random_sample_transcribe(_dir(n)),
                    project, [t_text, t_audio])

            with gr.TabItem("Vocab Check"):
                vocab_file = gr.Textbox(label="Vocab file",
                                        value="data/vocab_korean.txt")
                tok = gr.Dropdown(["kor_grapheme", "kor_phoneme", "kor_allophone",
                                   "pinyin", "char"], value="kor_grapheme",
                                  label="Tokenizer")
                info = gr.Textbox(label="Info")
                missing = gr.Textbox(label="Missing symbols")
                gr.Button("Check").click(
                    lambda n, v, t: vocab_check(_dir(n), v, t),
                    [project, vocab_file, tok], [info, missing])

                sym = gr.Textbox(label="Symbols to add (comma-separated)")
                ck_path = gr.Textbox(label="Checkpoint to extend (.npz)")
                ext_out = gr.Textbox(label="Extend result")

                def _extend(vfile, symbols, ck):
                    from korean_f5_tts_tpu_torch.train.vocab_extend import extend_checkpoint

                    out_ck = ck.replace(".npz", "_extended.npz")
                    out_vocab = vfile.replace(".txt", "_extended.txt")
                    n = extend_checkpoint(ck, out_ck, vfile,
                                          [s for s in symbols.split(",") if s],
                                          out_vocab)
                    return f"{out_ck} / {out_vocab} ({n} tokens)"

                gr.Button("Extend vocab + model").click(
                    _extend, [vocab_file, sym, ck_path], ext_out)

            with gr.TabItem("Prepare Data"):
                tok2 = gr.Dropdown(["char", "kor_grapheme", "kor_phoneme",
                                    "kor_allophone"], value="char", label="Tokenizer")
                prep_out = gr.Textbox(label="Arrow output")

                def _prepare(name, t):
                    return _project(name).prepare_arrow(tokenizer=t)

                gr.Button("Prepare").click(_prepare, [project, tok2], prep_out)
                p_text = gr.Textbox(label="Random prepared sample (tokens)")
                p_audio = gr.Audio(label="Audio", type="filepath")
                gr.Button("Random sample").click(
                    lambda n: get_random_sample_prepare(_dir(n)),
                    project, [p_text, p_audio])

            with gr.TabItem("Train Model"):
                with gr.Row():
                    exp = gr.Dropdown(["F5TTS_v1_Base", "F5TTS_Base", "E2TTS_Base"],
                                      value="F5TTS_v1_Base", label="Model")
                    tok3 = gr.Textbox(value="char", label="Tokenizer")
                settings_json = gr.JSON(label="Settings")
                gr.Button("Load settings").click(
                    lambda n: load_settings(n), project, settings_json)
                gr.Button("Auto-configure").click(
                    lambda n: calculate_train(_dir(n), gpu_memory_gb=device_memory_gb(device)),
                    project, settings_json)

                def _save(name, s):
                    return save_settings(name, s or {})

                gr.Button("Save settings").click(_save, [project, settings_json], status)
                train_log = gr.Textbox(label="Training")
                proc_state = gr.State({})

                def _start(name, e, t, st):
                    proj = st.get("proj") or _project(name)
                    pid = proj.start_training(exp_name=e, tokenizer=t)
                    return {"proj": proj}, f"training pid {pid}"

                def _stop(st):
                    if st.get("proj"):
                        st["proj"].stop_training()
                    return "stopped"

                gr.Button("Start").click(_start, [project, exp, tok3, proc_state],
                                         [proc_state, train_log])
                gr.Button("Stop").click(_stop, proc_state, train_log)

            with gr.TabItem("Test Model"):
                ckpts = gr.Dropdown(choices=[], label="Checkpoint",
                                    allow_custom_value=True)
                gr.Button("List checkpoints").click(
                    lambda n: gr.update(choices=get_checkpoints_project(n)),
                    project, ckpts)
                ref_a = gr.Audio(label="Reference audio", type="filepath")
                ref_t = gr.Textbox(label="Reference text")
                gen_t = gr.Textbox(label="Text to generate")
                nfe = gr.Slider(4, 64, value=32, step=1, label="NFE")
                audio_out = gr.Audio(label="Generated")

                def _infer(ck, ra, rt, gt, n_):
                    sr, wav = test_model_infer(ck, ra, rt, gt, nfe_step=int(n_), device=device)
                    return (sr, wav)

                gr.Button("Synthesize").click(_infer, [ckpts, ref_a, ref_t, gen_t, nfe],
                                              audio_out)

            with gr.TabItem("Prune Checkpoint"):
                ck_in = gr.Textbox(label="Checkpoint path")
                pr_out = gr.Textbox(label="Pruned path")

                def _prune(name, ck):
                    from korean_f5_tts_tpu_torch.train.vocab_extend import prune_checkpoint

                    dst = ck.replace(".npz", "_pruned.npz")
                    prune_checkpoint(ck, dst)
                    return dst

                gr.Button("Prune").click(_prune, [project, ck_in], pr_out)

            with gr.TabItem("System Info"):
                # reference finetune_gradio.py:1833-1845: stats textbox +
                # Update Stats button driving get_combined_stats
                stats_box = gr.Textbox(label="GPU and CPU Information",
                                       lines=20)
                gr.Button("Update Stats").click(
                    lambda: get_combined_stats(), outputs=stats_box)
                gr.JSON(system_stats, label="System")
    return app


def main(argv=None):  # pragma: no cover - serves until interrupted
    import argparse

    p = argparse.ArgumentParser(prog="python -m korean_f5_tts_tpu_torch.train.finetune_gradio")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    app = build_app(device=require_device(args.device))
    app.queue().launch()


if __name__ == "__main__":
    main()
