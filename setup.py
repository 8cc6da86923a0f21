"""Package build — ≙ reference ``lib/setup.py`` (which built the Cython/CUDA
extensions; here the native helper is a plain C++ shared library built by
``mnc_tpu/native/build`` at import, or ahead of time via this setup's
build_ext)."""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "build the native C++ helper library"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        native = Path(__file__).parent / "mnc_tpu" / "native"
        subprocess.run(["make", "-C", str(native)], check=True)


setup(
    name="mnc_tpu",
    version="0.1.0",
    description="TPU-native Multi-task Network Cascades (instance segmentation)",
    packages=find_packages(include=["mnc_tpu", "mnc_tpu.*",
                                    "mnc_tpu_torch", "mnc_tpu_torch.*"]),
    package_data={"mnc_tpu.native": ["*.cpp", "Makefile"],
                  "mnc_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "pyyaml"],
    extras_require={
        "data": ["opencv-python", "scipy"],
        "ckpt": ["orbax-checkpoint"],
        "torch": ["torch"],
    },
    cmdclass={"build_native": BuildNative},
)
