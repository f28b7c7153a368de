"""Command-line entry points of the port: inference_sr (I2VGen-XL SR),
sample_sr (CogVideoX SR), sample_t2v (CogVideoX text-to-video), serve (the
resident I2VGen-XL daemon over a file queue), web (an HTTP front-end over
that queue) and warm_cache (the kernels built ahead of time). Checkpoint
conversion is convert/cli.py."""
