"""Losses of the 2-level training path (the port of ``seghiero_tpu/losses``):
``hiera.py`` (target preparation, logit-space BCE forms),
``tree_triplet.py`` (range variant) and ``fast.py`` (the C-major
composite and the aux CE)."""
