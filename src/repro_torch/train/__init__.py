"""Serve-step builders and sampled evaluation of the LM (training waits
for a later slice: ROADMAP.md)."""
