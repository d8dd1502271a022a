"""korean_f5_tts_tpu_torch: the PyTorch/CUDA port of korean_f5_tts_tpu.

The JAX package stays the reference; this package mirrors its module layout
and names and imports torch, never jax. The serving path runs in it: text
embedding, the 16-step CFG Euler sampler over the DiT, the Vocos decode and
the batching HTTP server. Its three hand-written Hopper kernels live in
csrc/ (prefix attention, the FF half-block, the conv-position grouped conv)
and build on first use into _build/.

Layout:
  config.py           DiTConfig, ModelConfig, presets
  ops/                kernel wrappers + plain versions, attention dispatch,
                      mel/STFT/ISTFT, the kernel build
  models/             modules, DiT, Vocos, the sampler
  infer/model.py      TTSModel, load_model
  serving/server.py   TTSService, HTTP handler, serve()
  train/checkpoint.py the weight converter from JAX trees and .npz files
  utils/              timestep schedules, audio helpers
"""

__version__ = "0.1.0"
