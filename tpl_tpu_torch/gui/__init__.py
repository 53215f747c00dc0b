from tpl_tpu_torch.gui.main import GuiServer

__all__ = ["GuiServer"]
