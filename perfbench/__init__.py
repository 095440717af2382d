"""The benchmark of ai_font_renderer_tpu_torch on one H100 (see
BENCHMARK.json and PERF.md). Imports neither JAX nor the JAX package."""
