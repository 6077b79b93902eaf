"""Native sources of the port: the CUDA kernels (built by ``ops._build``)
and the C++ host library (built by ``host_lib``)."""
