"""Host-side native code of the port: the COLMAP binary-model parser
(`colmap_native.cpp`, a plain C interface), built with g++ at first use and
loaded with ctypes (`build.py`)."""
