"""Launchers of the port: ``prefill`` (the full-sequence forward of a
batch of prompts, the serving prefill output)."""
