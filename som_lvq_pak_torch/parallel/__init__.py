"""The (data, model) mesh on torch.distributed: one process per mesh
position (mesh), and the sharded winner searches and training steps that
run in each of them (sharded).  Counterpart of som_lvq_pak_tpu/parallel/."""
