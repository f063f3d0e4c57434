"""Training of the PyTorch port, the counterpart of ``kandinsky2_tpu/train``:
decoder (unCLIP 2.1) fine-tuning (``train_unclip``, its inpainting variant
and the ``train_2_1_unclip`` CLI, with ``masks``), prior training
(``train_prior`` and the ``train_prior_cli`` CLI), LoRA (``train_lora``)
and step distillation (``distill``) of the 2.2 decoder UNet, and what they
run (timestep samplers, EMA, Adafactor, fp32 masters, checkpoints, the CSV
data pipeline)."""
