"""Command-line entry points of the port: inference_sr (I2VGen-XL) and
sample_sr (CogVideoX). Checkpoint conversion is convert/cli.py."""
