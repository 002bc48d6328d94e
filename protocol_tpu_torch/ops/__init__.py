"""Compute on torch: the converge core (dense, gather SpMV, Clos-routed
SpMV), static-permutation routing, and the kernels written by hand for
Hopper (``ops.kernels``)."""

from .clos import RoutePlan, apply_route, plan_route, route_bits
from .converge import (
    converge_dense_adaptive,
    converge_dense_fixed,
    converge_sparse_adaptive,
    converge_sparse_fixed,
    operator_arrays,
    spmv,
)
from .routed import (
    RoutedOperator,
    build_routed_operator,
    converge_routed_adaptive,
    converge_routed_fixed,
    operator_from_numpy,
    routed_arrays,
    spmv_routed,
)

__all__ = [
    "RoutePlan",
    "apply_route",
    "plan_route",
    "route_bits",
    "RoutedOperator",
    "build_routed_operator",
    "converge_routed_adaptive",
    "converge_routed_fixed",
    "operator_from_numpy",
    "routed_arrays",
    "spmv_routed",
    "converge_dense_fixed",
    "converge_dense_adaptive",
    "converge_sparse_fixed",
    "converge_sparse_adaptive",
    "operator_arrays",
    "spmv",
]
