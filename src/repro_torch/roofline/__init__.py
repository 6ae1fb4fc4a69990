"""The card's table (``hw``) and the block tuner of the two GAB kernels
(``kernel_tune``)."""
