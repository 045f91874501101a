"""Operations of the port that are not kernels of their own: the int8
quantized convolution and linear layer (``ops/int8.py``)."""
