"""The benchmark of behavior_driven_video_synthesis_tpu_torch: one command
runs one cell once (``benchmark/run.py``); ``BENCHMARK.json`` at the root
of the checkout names the cells and metrics."""
