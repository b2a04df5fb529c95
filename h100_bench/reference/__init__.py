"""The plain reference: the 4D-STraG DiT, its denoise loop and its
training step in fp32 with TF32 off, written from the model's
description (Wan2.1, MoRe4D). It imports nothing of the program and
takes no tensor the program made: weights and inputs come again from
the seed (``h100_bench/inputs.py``)."""
