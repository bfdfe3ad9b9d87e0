"""Serving of the port: the batched prefill + decode engine."""
