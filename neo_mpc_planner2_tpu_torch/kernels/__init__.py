"""The hand-written CUDA kernels (sources in `../csrc/`): their build step
(`build`) and ctypes binding (`binding`). Nothing is compiled or loaded when
this package is imported; the first launch builds the library."""
