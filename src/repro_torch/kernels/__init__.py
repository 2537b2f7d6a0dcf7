"""Hand-written Hopper kernels of the port, their plain versions, and the
dispatcher that picks between them (``ops``)."""
