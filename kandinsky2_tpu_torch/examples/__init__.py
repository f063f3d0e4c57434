"""Example scripts of the PyTorch port, one for each of the repository's
``examples/`` that runs on one card:

    python -m kandinsky2_tpu_torch.examples.<name> [--small] [--device cuda]

``--small`` builds a small random-weight pipeline (no checkpoints needed);
without it the 2.0 / 2.1 / 2.2 scripts load the published checkpoints from
a local cache (``--cache-dir``) through ``get_kandinsky2``, which raises,
naming the file, for anything missing.  Every script runs on the card
unless given ``--device cpu``.  Each does its work in ``main()``, so
importing one runs nothing.
"""
