"""The port's dataset preparation and loading against the JAX package's, on
the CPU.

One tiny corpus of seeded noise wavs with Korean transcripts (one clip too
short for the 0.3-30 s filter, one at 16 kHz) goes through each package's
train/datasets/prepare.py into its own data directory: raw.arrow,
duration.json and vocab.txt must be equal. Then load_dataset reads the
files in every form it takes (CustomDataset by name, CustomDatasetPath, a
mel.arrow of precomputed mels in the IPC stream and file formats, and
HFDataset from a `datasets` save_to_disk directory): lengths, frame lengths
and texts are equal, mels within 1e-4 (the two mel front-ends' fp32
rounding, as tests/test_torch_train.py:test_wav_rows_give_the_jax_mel holds
them).
"""

import json
import os

import numpy as np
import pyarrow as pa
import pytest
from scipy.io import wavfile

from korean_f5_tts_tpu.data import dataset as jds
from korean_f5_tts_tpu.train.datasets import prepare as jprep
from korean_f5_tts_tpu_torch.data import dataset as pds
from korean_f5_tts_tpu_torch.train.datasets import prepare as pprep

TEXTS = ["안녕하세요 반갑습니다.", "국물이 같이 있어요.", "신라 시대의 값이", "짧다"]
SECONDS = [(1.2, 24_000), (0.9, 16_000), (1.6, 24_000), (0.2, 24_000)]
TOKENIZER = "kor_allophone"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    os.makedirs(root / "wavs")
    rng = np.random.default_rng(0)
    lines = []
    for i, ((secs, sr), text) in enumerate(zip(SECONDS, TEXTS)):
        wav = (0.3 * rng.standard_normal(int(secs * sr))).astype(np.float32)
        wavfile.write(root / "wavs" / f"{i}.wav", sr, wav)
        lines.append(f"{i}.wav|{text}")
    (root / "metadata.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    out = {}
    for name, prep in (("jax", jprep), ("port", pprep)):
        data_dir = str(root / f"data_{name}")
        out[name] = prep.prepare(str(root), "tiny", TOKENIZER, corpus_format="csv",
                                 use_n2gk_plus=True, data_dir=data_dir)
    return root, out


def _read(path):
    with pa.memory_map(path) as src:
        return pa.ipc.open_stream(src).read_all().to_pylist()


def test_prepare_writes_what_jax_writes(corpus):
    _, out = corpus
    assert os.path.basename(out["port"]) == os.path.basename(out["jax"]) == f"tiny_{TOKENIZER}"
    rows = _read(os.path.join(out["port"], "raw.arrow"))
    assert rows == _read(os.path.join(out["jax"], "raw.arrow")) and len(rows) == len(TEXTS)
    for name in ("duration.json", "vocab.txt"):
        with open(os.path.join(out["port"], name), encoding="utf-8") as f:
            got = f.read()
        with open(os.path.join(out["jax"], name), encoding="utf-8") as f:
            assert got == f.read(), name
    durations = json.load(open(os.path.join(out["port"], "duration.json")))["duration"]
    np.testing.assert_allclose(durations, [s for s, _ in SECONDS], rtol=1e-6)


def _same_items(got_ds, want_ds, n=None):
    assert len(got_ds) == len(want_ds)
    for i in range(n or len(want_ds)):
        assert got_ds.get_frame_len(i) == pytest.approx(want_ds.get_frame_len(i), rel=1e-12)
        got, want = got_ds[i], want_ds[i]
        assert got["text"] == want["text"]
        assert got["mel_spec"].shape == want["mel_spec"].shape
        np.testing.assert_allclose(got["mel_spec"], want["mel_spec"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dataset_type", ["CustomDataset", "CustomDatasetPath"])
def test_load_dataset_reads_the_prepared_files(corpus, dataset_type):
    root, out = corpus
    if dataset_type == "CustomDataset":
        args = dict(dataset_name="tiny", tokenizer=TOKENIZER, data_dir=str(root / "data_jax"))
    else:
        args = dict(dataset_name=out["jax"], dataset_type=dataset_type)
    want = jds.load_dataset(**args)
    got = pds.load_dataset(**args)
    assert isinstance(got, pds.CustomDataset) and got.durations == want.durations
    _same_items(got, want)
    assert got[3]["text"] == got[0]["text"]  # the 0.2 s clip is skipped forward


@pytest.mark.parametrize("fmt", ["stream", "file"])
def test_load_dataset_reads_a_mel_arrow(tmp_path, fmt):
    rng = np.random.default_rng(1)
    rows = [{"mel_spec": rng.standard_normal((100, f)).astype(np.float32).tolist(),
             "text": t, "duration": f * 256 / 24_000} for f, t in ((90, "ab"), (140, "cd e"))]
    table = pa.Table.from_pylist(rows)
    new = pa.ipc.new_stream if fmt == "stream" else pa.ipc.new_file
    with pa.OSFile(str(tmp_path / "mel.arrow"), "wb") as sink, new(sink, table.schema) as w:
        w.write_table(table)
    args = dict(dataset_name=str(tmp_path), dataset_type="CustomDatasetPath", audio_type="mel")
    want, got = jds.load_dataset(**args), pds.load_dataset(**args)
    assert got.durations is None and got.preprocessed_mel
    _same_items(got, want)
    np.testing.assert_array_equal(got[1]["mel_spec"], np.asarray(rows[1]["mel_spec"], np.float32))
    with pytest.raises(FileNotFoundError):
        pds.load_dataset(str(tmp_path), dataset_type="CustomDatasetPath")  # no raw.arrow


def test_hf_dataset_from_a_save_to_disk_directory(tmp_path):
    import datasets

    rng = np.random.default_rng(2)
    audio = [{"array": (0.3 * rng.standard_normal(int(s * sr))).astype(np.float32),
              "sampling_rate": sr} for s, sr in SECONDS]
    datasets.Dataset.from_dict({"audio": audio, "text": TEXTS}).save_to_disk(
        str(tmp_path / "hf"))
    args = dict(dataset_name=str(tmp_path / "hf"), dataset_type="HFDataset")
    want, got = jds.load_dataset(**args), pds.load_dataset(**args)
    assert isinstance(got, pds.HFDataset)
    _same_items(got, want)
    assert got[3]["text"] == TEXTS[0]  # too short: the next item, wrapping around
