"""Data layer of the port: the H5 contract, offline preprocessing (numpy),
and the device-resident dataset."""

from .pipeline import DeviceDataset, HostDataset, build_dataset  # noqa: F401
from .preprocess import Preprocessor  # noqa: F401
from .synthetic import make_synthetic_arrays, write_synthetic_h5  # noqa: F401
