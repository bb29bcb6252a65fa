#!/usr/bin/env python3
"""Package metadata (pip-installable, mirrors the reference's setup.py)."""

from setuptools import find_packages, setup

setup(
    name='multigriddet-tpu',
    version='0.1.0',
    description=('TPU-native JAX implementation of MultiGridDet: '
                 'multi-grid redundant assignment one-stage detection'),
    packages=find_packages(include=['multigriddet_tpu',
                                    'multigriddet_tpu.*',
                                    'multigriddet_tpu_torch',
                                    'multigriddet_tpu_torch.*']),
    py_modules=['train', 'infer', 'eval'],
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy', 'pyyaml',
        'pillow',
    ],
    extras_require={
        'viz': ['matplotlib', 'opencv-python'],
        'test': ['pytest'],
    },
    entry_points={
        'console_scripts': [
            'multigriddet-train=train:main',
            'multigriddet-infer=infer:main',
            'multigriddet-eval=eval:main',
        ],
    },
)
