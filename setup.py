from setuptools import find_packages, setup

setup(
    name="colate_tpu",
    version="0.1.0",
    description="TPU-native coalescence-rate engine (Colate-compatible)",
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    entry_points={"console_scripts": [
        "colate-tpu=colate_tpu.cli:main",
        "colate-tpu-torch=colate_tpu_torch.cli:main",
    ]},
)
