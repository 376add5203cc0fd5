// Native padded-graph batcher: the host-side hot loop of the input
// pipeline (a copy of the JAX package's deepdfa_tpu/native/src/batcher.cpp).
//
// The reference leans on DGL's C++ dgl.batch to splice graphs per step
// (DDFA/sastvd/linevd/datamodule.py:110-141); this framework batches into
// fixed budgets (deepdfa_tpu_torch/graphs/batch.py) and this function does
// the per-graph offsetting/scatter in C++ instead of a Python loop.
//
// Inputs are the per-graph arrays concatenated back-to-back; outputs are the
// zero-initialized padded batch arrays. Returns 0 on success or -(gi+1) if
// graph gi would overflow the node/edge budget.

#include <cstdint>
#include <cstring>

extern "C" {

int32_t batch_fill(int32_t n_graphs,
                   const int32_t* num_nodes,       // [n_graphs]
                   const int32_t* num_edges,       // [n_graphs] (pre-self-loop)
                   const int32_t* senders_cat,     // [sum(num_edges)]
                   const int32_t* receivers_cat,
                   const int32_t* vuln_cat,        // [sum(num_nodes)]
                   const int32_t* feats_cat,       // [n_subkeys, sum(num_nodes)]
                   int32_t n_subkeys,
                   int32_t add_self_loops,
                   int32_t max_nodes, int32_t max_edges,
                   int32_t* feats_out,             // [n_subkeys, max_nodes]
                   int32_t* vuln_out,              // [max_nodes]
                   int32_t* senders_out,           // [max_edges]
                   int32_t* receivers_out,
                   int32_t* node_graph,            // [max_nodes]
                   uint8_t* node_mask,             // [max_nodes]
                   uint8_t* edge_mask) {           // [max_edges]
  int64_t total_nodes = 0, total_edges = 0;
  for (int32_t g = 0; g < n_graphs; ++g) {
    total_nodes += num_nodes[g];
    total_edges += num_edges[g];
  }

  int32_t node_off = 0, edge_off = 0;
  int64_t in_node = 0, in_edge = 0;
  for (int32_t g = 0; g < n_graphs; ++g) {
    const int32_t n = num_nodes[g];
    const int32_t e_in = num_edges[g];
    const int32_t e = e_in + (add_self_loops ? n : 0);
    if (node_off + n > max_nodes || edge_off + e > max_edges) return -(g + 1);

    for (int32_t k = 0; k < n_subkeys; ++k) {
      std::memcpy(feats_out + (int64_t)k * max_nodes + node_off,
                  feats_cat + (int64_t)k * total_nodes + in_node,
                  n * sizeof(int32_t));
    }
    std::memcpy(vuln_out + node_off, vuln_cat + in_node, n * sizeof(int32_t));
    for (int32_t i = 0; i < e_in; ++i) {
      senders_out[edge_off + i] = senders_cat[in_edge + i] + node_off;
      receivers_out[edge_off + i] = receivers_cat[in_edge + i] + node_off;
    }
    if (add_self_loops) {
      for (int32_t i = 0; i < n; ++i) {
        senders_out[edge_off + e_in + i] = node_off + i;
        receivers_out[edge_off + e_in + i] = node_off + i;
      }
    }
    for (int32_t i = 0; i < n; ++i) node_graph[node_off + i] = g;
    std::memset(node_mask + node_off, 1, n);
    std::memset(edge_mask + edge_off, 1, e);

    node_off += n;
    edge_off += e;
    in_node += n;
    in_edge += e_in;
  }
  return 0;
}

}  // extern "C"
