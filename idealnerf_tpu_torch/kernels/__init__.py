"""Hand-written CUDA kernels and their wrappers. Importing this package
builds nothing: the library is compiled at the first CUDA launch
(kernels/build.py)."""
