from tpu_knn_torch.kdtree.build import KDTree, build_kdtree

__all__ = ["build_kdtree", "KDTree"]
