"""The benchmark's plain reference: both I2PNet families in float32 with
plain torch operations (``nets``), the training step (``train``) and the
control's fp8 rounding (``quant``). Imports nothing of the program."""
