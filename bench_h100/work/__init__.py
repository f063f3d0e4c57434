"""The work (flops and bytes) of each model call, counted from shapes."""
