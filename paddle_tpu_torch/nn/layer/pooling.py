"""Pooling layers: the port of `paddle_tpu/nn/layer/pooling.py`, each a
Layer over its functional (`functional/pooling.py`)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "LPPool1D", "LPPool2D", "MaxUnPool2D"]


class _PoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AvgPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode)

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.kw["exclusive"], self.kw["ceil_mode"])


class AvgPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.kw["ceil_mode"], self.kw["exclusive"],
                            data_format=self.kw["data_format"])


class AvgPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.kw["ceil_mode"], self.kw["exclusive"],
                            data_format=self.kw["data_format"])


class MaxPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.kw["return_mask"], self.kw["ceil_mode"])


class MaxPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.kw["return_mask"], self.kw["ceil_mode"],
                            self.kw["data_format"])


class MaxPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.kw["return_mask"], self.kw["ceil_mode"],
                            self.kw["data_format"])


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.lp_pool1d(x, *self.args)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return F.lp_pool2d(x, *self.args)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, *self.args)
