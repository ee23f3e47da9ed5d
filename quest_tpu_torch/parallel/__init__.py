"""Layout planning for one device (see :mod:`.layout`)."""

from .layout import LayoutPlan, plan_layout

__all__ = ["LayoutPlan", "plan_layout"]
