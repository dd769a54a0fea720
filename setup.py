from setuptools import setup, find_packages

with open("README.md", "r", encoding="utf-8") as fh:
    long_description = fh.read()

setup(
    name="fovvideovdp_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) FovVideoVDP: full-reference "
                "foveated video/image quality metric",
    long_description=long_description,
    long_description_content_type="text/markdown",
    packages=find_packages(include=["fovvideovdp_tpu", "fovvideovdp_tpu.*",
                                    "fovvideovdp_tpu_torch",
                                    "fovvideovdp_tpu_torch.*"]),
    package_data={
        "fovvideovdp_tpu": ["data/*.json", "data/*.npz",
                            "data/xla_seed_cache/*"],
        "fovvideovdp_tpu_torch": ["data/*.json", "data/*.npz", "csrc/*.cu*",
                                  "native/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "scipy",
    ],
    extras_require={
        "media": ["opencv-python", "Pillow"],
        "test": ["pytest"],
        # the PyTorch/CUDA port (fovvideovdp_tpu_torch); its kernels are
        # compiled at first use and need the CUDA toolkit's nvcc
        "torch": ["torch"],
    },
    entry_points={
        "console_scripts": ["fvvdp=fovvideovdp_tpu.run_fvvdp:main",
                            "fvvdp-torch=fovvideovdp_tpu_torch.run_fvvdp:main"],
    },
)
