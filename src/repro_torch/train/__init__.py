"""Train, prefill and serve step builders (``step``; the train step
also on a mesh) and sampled evaluation of the LM."""
