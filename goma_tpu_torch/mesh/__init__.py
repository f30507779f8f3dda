from goma_tpu_torch.mesh.mesh import Block, Mesh, SideSet
from goma_tpu_torch.mesh.generators import box_mesh, rectangle_mesh
from goma_tpu_torch.mesh.immersed import circle_block, polyline_block
