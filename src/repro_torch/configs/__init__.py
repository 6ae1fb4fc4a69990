"""Architecture configs of the language-model template (one module per
arch, plain dataclasses copied from the JAX package) and the registry."""
