"""Evaluation harness of the port (counterpart of korean_f5_tts_tpu/eval/):
text metrics, testset parsing and bucketed prompts, the Korean tokenizer
grid, the validation, CoreaSpeech and KUB harnesses, batched eval synthesis
and the ECAPA-TDNN speaker encoder. ASR, MOS and speaker backends are
injected as callables; nothing is downloaded."""
