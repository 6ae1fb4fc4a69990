"""Language-model stack of the port: layers, the decoder-only transformer
over layer patterns ``G``/``L``/``R``/``K`` with dense or mixture-of-experts
FFNs, the encoder-decoder, and the model zoo with the weight carrier
between the JAX package's parameter tree and the port's modules."""
