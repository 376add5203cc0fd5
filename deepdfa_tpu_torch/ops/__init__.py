"""Message-passing ops: host-side adjacency construction, the band SpMM
and the fused GNN step kernels (``fused_gnn``)."""
