"""The port's own ctypes bindings over the repo's C++ merge core
(`native/dt_core.cpp`), built into `diamond_types_tpu_torch/_build/`."""
