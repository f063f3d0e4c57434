"""Host tokenizers of 2.1 inference, copies of ``kandinsky2_tpu/tokenizers``:
the CLIP BPE tokenizer of the prior's text tower and its stdlib stand-in
for ftfy's text repair."""

from .clip_bpe import CLIPBPETokenizer
