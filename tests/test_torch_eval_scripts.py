"""The port's four measuring scripts and the eval entry points' mains, run on
the CPU at a tiny size with `--device cpu`.

Each script prints its JSON line(s) with the keys its protocol names, and
the kernel launch counters stay 0 (the CPU takes the plain versions). The
mains read small files (tests/_torch_port_util.py:eval_main_files), load a
tiny DiT (dim 32, depth 2) from its .npz and run their loops end to end;
get_reference_mapping's main writes what the JAX package's writes, byte for
byte. Timings printed here are CPU smoke numbers, not measurements.
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_util import EVAL_ARCH, eval_main_files
from korean_f5_tts_tpu.eval import get_reference_mapping as jmapping
from korean_f5_tts_tpu_torch.config import model_config_of
from korean_f5_tts_tpu_torch.eval import eval_infer_batch, eval_librispeech_test_clean
from korean_f5_tts_tpu_torch.eval import eval_seedtts_testset, eval_utmos, evaluate_coreaspeech
from korean_f5_tts_tpu_torch.eval import evaluate_korean, evaluate_kub, get_reference_mapping
from korean_f5_tts_tpu_torch.eval import validate_models
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.scripts import (
    bench_grpc_live,
    bench_mixed_batch,
    bench_serving_throughput,
    profile_serving_request,
)

SR = 24_000

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """At these tiny shapes more torch threads only contend with the other
    test workers of the run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SCRIPTS = {
    # name: (main, argv, keys of each JSON line it prints, number of JSON lines)
    "bench_mixed_batch": (bench_mixed_batch.main, [
        "--tiny", "--batch", "2", "--iters", "1", "--steps", "2"],
        {"metric", "batch", "durations", "steps", "mode", "model", "device", "joint", "split",
         "l20_baseline"}, 1),
    "profile_serving_request": (profile_serving_request.main, [
        "--tiny", "--reps", "1", "--nfe_step", "2"],
        {"stage_ms_median", "reps", "nfe_step", "gen_audio_s", "duration_frames", "model",
         "device", "protocol"}, 1),
    "bench_serving_throughput": (bench_serving_throughput.main, [
        "--tiny", "--n_requests", "2", "--concurrency", "1", "2", "--nfe_step", "2",
        "--gen_seconds", "1"],
        {"n", "concurrency", "latency_ms_avg", "latency_ms_p50", "latency_ms_p95",
         "latency_ms_p99", "total_audio_s", "rtf", "protocol", "nfe_step", "batch_sizes",
         "device"}, 2),
    "bench_grpc_live": (bench_grpc_live.main, [
        "--in_process", "--tiny", "--n", "2", "--warm", "1", "--nfe_step", "2"],
        {"protocol", "n_items", "gen_seconds", "latency_p50_ms", "latency_p95_ms",
         "latency_avg_ms", "wire_null_ms", "rtf_p50", "reference_l20_avg_ms"}, 1),
}


def _json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_runs_on_the_cpu(name, capsys):
    main, argv, keys, n_lines = SCRIPTS[name]
    reset_launch_counts()
    result = main(argv + ["--device", "cpu"])
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    lines = _json_lines(capsys.readouterr().out)
    if name == "profile_serving_request":  # one line per run, the medians last
        assert len(lines) == 1 + 1 and set(lines[0]) == set(
            lines[-1]["stage_ms_median"])
        lines = lines[-1:]
    assert len(lines) == n_lines and all(set(line) == keys for line in lines)
    assert lines == (result if isinstance(result, list) else [result])
    for line in lines:
        assert line.get("device", "cpu") == "cpu"
    if name == "bench_mixed_batch":
        r = lines[0]
        assert r["durations"] == [768, 1536] and r["mode"] == "fp32"
        assert all(len(r[k]["runs"]) == 1 and r[k]["median"] > 0 for k in ("joint", "split"))
        assert r["l20_baseline"] == 0.0394
    elif name == "profile_serving_request":
        stages = lines[0]["stage_ms_median"]
        assert set(stages) == {"ref_mel_ms", "tokenize_ms", "sample_ms", "wav_readback_ms",
                               "mel_readback_ms", "host_slice_ms", "total_ms"}
        assert stages["sample_ms"] > 0 and lines[0]["gen_audio_s"] > 0
    elif name == "bench_serving_throughput":
        assert [r["concurrency"] for r in lines] == [1, 2]
        assert all(r["n"] == 2 and r["total_audio_s"] > 0 and r["rtf"] > 0 for r in lines)
        assert sum(lines[0]["batch_sizes"]) == sum(lines[1]["batch_sizes"]) == 2
    else:
        r = lines[0]
        assert r["n_items"] == 2 and r["gen_seconds"] > 0 and r["latency_p50_ms"] > 0
        assert "InProcessClient" in r["protocol"]


def test_grpc_live_loop_takes_any_client():
    """run() drives any object with ready() and synthesize()."""
    class Fake:
        calls = []

        def ready(self):
            return True

        def synthesize(self, ref_wav, ref_text, target_text, request_id="1"):
            self.calls.append((ref_wav.size, request_id))
            return np.zeros(48_000, np.float32), 24_000

    fake = Fake()
    r = bench_grpc_live.run(fake, n=3, warm=1, ref_seconds=0.5, protocol="Fake")
    assert [c[1] for c in fake.calls] == ["warm0", "0", "1", "2"]
    assert fake.calls[0][0] == 12_000 and r["n_items"] == 3 and r["gen_seconds"] == 2.0
    assert r["protocol"].startswith("Fake.synthesize")

    class NotReady(Fake):
        def ready(self):
            return False

    with pytest.raises(RuntimeError, match="not ready"):
        bench_grpc_live.run(NotReady(), n=1, warm=0)


# ---------------------------------------------------------------------------
# the eval mains
# ---------------------------------------------------------------------------


def _speech(seconds, seed=0):
    tt = np.arange(int(seconds * SR)) / SR
    noise = np.random.default_rng(seed).standard_normal(tt.size)
    return (0.3 * (np.sin(2 * np.pi * (150 + 300 * tt) * tt) + 0.1 * noise)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    refs = []
    for i in range(3):
        path = str(d / f"ref{i}.wav")
        wavfile.write(path, SR, (_speech(0.8 + 0.2 * i, i) * 32767).astype(np.int16))
        refs.append(path)
    train = [{"audio_path": refs[i], "text": t, "duration": 3.5 + i, "speaker": f"s{i % 2}"}
             for i, t in enumerate(["first reference.", "second one!", "third reference?"])]
    test = [{"audio_path": "", "text": t, "speaker": f"s{i % 2}", "duration": 4.0}
            for i, t in enumerate(["hello there.", "good morning!"])]
    for name, rows in (("train.jsonl", train), ("test.jsonl", test)):
        with open(d / name, "w", encoding="utf-8") as f:
            f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in rows)
    files = eval_main_files()
    for mode in ("kor_grapheme", "kor_allophone"):
        (d / "ckpts" / mode).mkdir(parents=True)
        shutil.copy(files["npz"], d / "ckpts" / mode / "model_7.npz")
    return d, refs


def _tiny():
    return ["--model", eval_main_files()["yaml"], "--device", "cpu"]


def test_evaluate_korean_and_validate_models_mains(corpus):
    d, _ = corpus
    reset_launch_counts()
    grid = evaluate_korean.main([
        "--test_metadata", str(d / "test.jsonl"), "--train_metadata", str(d / "train.jsonl"),
        "--ckpt_root", str(d / "ckpts"), "--modes", "kor_grapheme", "kor_allophone",
        "--steps", "7", "8", "--results_dir", str(d / "grid"), "--nfe_step", "2", *_tiny()])
    assert [(r["mode"], r["step"], r["n"]) for r in grid] == [
        ("kor_grapheme", 7, 2), ("kor_allophone", 7, 2)]
    for mode in ("kor_grapheme", "kor_allophone"):
        rows = list(csv.DictReader(open(d / "grid" / f"{mode}_7" / "details.csv")))
        assert [r["utt"] for r in rows] == ["t0000", "t0001"]
        assert all((d / "grid" / f"{mode}_7" / f"{r['utt']}.wav").exists() for r in rows)
    val = validate_models.main([
        "--val_metadata", str(d / "train.jsonl"), "--ckpt_root", str(d / "ckpts"),
        "--modes", "VCP", "--steps", "7", "--results_dir", str(d / "val"),
        "--nfe_step", "2", *_tiny()])
    assert [r["mode"] for r in val] == ["kor_allophone"]  # VCP, a legacy name
    summary = list(csv.DictReader(open(d / "val" / "validation_summary.csv")))
    assert [r["mode"] for r in summary] == ["kor_allophone"]
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_coreaspeech_kub_and_batch_mains(corpus, capsys):
    d, refs = corpus
    npz = eval_main_files()["npz"]
    summary = evaluate_coreaspeech.main([
        "--valid_metadata", str(d / "test.jsonl"), "--train_metadata", str(d / "train.jsonl"),
        "--ckpt_file", npz, "--out_dir", str(d / "corea"), "--nfe_step", "2", *_tiny()])
    assert summary["n"] == 2
    assert sorted(os.listdir(d / "corea")) == ["details.csv", "v00000.wav", "v00001.wav"]
    # the rows are read whole, so the speaker key reaches the mapping
    test = [{"utt": f"v{i:05d}", **r}
            for i, r in enumerate(evaluate_coreaspeech.read_jsonl_rows(str(d / "test.jsonl")))]
    mapping = evaluate_coreaspeech.build_same_speaker_mapping(
        test, evaluate_coreaspeech.read_jsonl_rows(str(d / "train.jsonl")))
    assert {u: m["speaker"] for u, m in mapping.items()} == {"v00000": "s0", "v00001": "s1"}
    kub = d / "kub.txt"
    kub.write_text("".join(f"{s}|{os.path.basename(refs[i])}|a reference.|3.0|{refs[2 - i]}|"
                           f"say this please.\n" for i, s in enumerate(("clean", "noisy"))),
                   encoding="utf-8")
    rows = evaluate_kub.main(["--test_list", str(kub), "--data_root", str(d), "--ckpt_file", npz,
                              "--out_dir", str(d / "kub"), "--nfe_step", "2", "--seed", "1",
                              *_tiny()])
    assert [(r["subset"], r["n"]) for r in rows] == [("clean", 1), ("noisy", 1)]
    assert (d / "kub" / "summary.csv").exists()
    lst = d / "meta.lst"
    lst.write_text("".join(f"u{i}|a reference.|{refs[i]}|some words to say.\n" for i in range(3)),
                   encoding="utf-8")
    out = eval_infer_batch.main(["-t", "seedtts_test_en", "--metalst", str(lst), "--ckpt_file",
                                 npz, "--expname", eval_main_files()["yaml"], "--output_dir",
                                 str(d / "batch"), "-nfe", "2", "--seed", "0", "--device",
                                 "cpu"])
    assert out.endswith("tiny_1250000_seedtts_test_en")
    assert sorted(os.listdir(out)) == ["u0.wav", "u1.wav", "u2.wav"]
    # SIM of the generated wavs against their prompts with the ECAPA .npz
    sim = eval_seedtts_testset.main(["--eval_task", "sim", "--metalst", str(lst),
                                     "--gen_wav_dir", out, "--ecapa_params",
                                     eval_main_files()["ecapa"], "--device", "cpu"])
    assert sim["n"] == 3 and -1.0 <= sim["mean"] <= 1.0
    assert len(open(os.path.join(out, "_sim_results.jsonl")).readlines()) == 3
    with pytest.raises(RuntimeError, match="ASR backend"):
        eval_seedtts_testset.main(["--metalst", str(lst), "--gen_wav_dir", out])
    with pytest.raises(RuntimeError, match="mos_fn"):
        eval_utmos.main(["--audio_dir", out])
    assert "over 3 utts" in capsys.readouterr().out


def test_librispeech_main_scores_sim(corpus, tmp_path):
    d, refs = corpus
    ls = tmp_path / "LibriSpeech"
    (ls / "61" / "70968").mkdir(parents=True)
    gen = tmp_path / "gen"
    gen.mkdir()
    for i in range(2):
        utt = f"61-70968-000{i}"
        shutil.copy(refs[i], ls / "61" / "70968" / f"{utt}.flac")
        shutil.copy(refs[2 - i], gen / f"61-70968-000{i + 2}.wav")
    lst = tmp_path / "ls.tsv"
    lst.write_text("".join(f"61-70968-000{i}\t2.0\tref words\t61-70968-000{i + 2}\t3.0\tgen\n"
                           for i in range(2)), encoding="utf-8")
    r = eval_librispeech_test_clean.main(["--eval_task", "sim", "--metalst", str(lst),
                                          "--librispeech_test_clean_path", str(ls),
                                          "--gen_wav_dir", str(gen), "--ecapa_params",
                                          eval_main_files()["ecapa"], "--device", "cpu"])
    assert r["n"] == 2 and np.isfinite(r["mean"])


def test_get_reference_mapping_main_writes_what_jax_writes(corpus, tmp_path):
    d, _ = corpus
    argv = ["--test_metadata", str(d / "test.jsonl"), "--train_metadata", str(d / "train.jsonl"),
            "--min_dur", "3.0", "--max_dur", "6.0", "--seed", "5"]
    jmapping.main(argv + ["--output", str(tmp_path / "j.jsonl")])
    mapping = get_reference_mapping.main(argv + ["--output", str(tmp_path / "p.jsonl")])
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert len(mapping) == 2 and all(m is not None for m in mapping.values())


def test_eval_mains_take_a_model_config_yaml():
    cfg = model_config_of(eval_main_files()["yaml"])
    assert cfg.arch.dim == EVAL_ARCH["dim"] and cfg.arch.depth == EVAL_ARCH["depth"]
    assert model_config_of("F5TTS_Base").name == "F5TTS_Base"
    with pytest.raises(ValueError, match="unknown model"):
        model_config_of("no_such_model")
