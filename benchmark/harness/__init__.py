"""The benchmark's general parts: inputs made from a seed (``scene``,
``graphs``), the traced slice (``trace``) and the comparison that decides
``correct`` (``checks``)."""
