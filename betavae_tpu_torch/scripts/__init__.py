"""The port's counterparts of the repository's ``scripts/``: ``scripts/X.py``
runs here as ``python -m betavae_tpu_torch.scripts.X``, with its flags and
defaults; each module is a thin ``main(argv=None)`` over the library."""
