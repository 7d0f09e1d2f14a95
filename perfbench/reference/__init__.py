"""The plain PyTorch reference that decides ``correct``.

It imports nothing of the port (nor JAX, nor the JAX package): it reads
the sizes from the benchmark's configuration file, makes nothing the
program made, and computes each model's forward pass, the GRPO loss and
AdamW in plain ``torch`` operations at the precision the configuration
states (float32 parameters, bfloat16 products, float32 norms, rotary
and softmax). ``precision.Precision("fp8")`` is the control: the
same reference with every weight product's operands rounded to fp8.
"""
