"""Decoder (unCLIP 2.1) fine-tuning of the PyTorch port: the counterpart of
``kandinsky2_tpu/train`` for ``train_unclip`` and what it runs (timestep
samplers, EMA, Adafactor, checkpoints, the CSV data pipeline) and the
``train_2_1_unclip`` CLI."""
