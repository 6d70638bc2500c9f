"""Policy mechanisms of MASK (port of `repro.core`).

  asid        -- address spaces / protection domains
  page_table  -- multi-level radix walks, PTE line addressing
  tlb         -- set-associative ASID-tagged TLB state (L1/L2/bypass cache)
  tokens      -- TLB-Fill Tokens epoch controller
  bypass      -- TLB-request-aware L2 data-cache bypass
  dram_sched  -- golden/silver/normal scheduler with its quotas
  design      -- composable design points: per-layer policy specs +
                 registry (register_design / get_design / list_designs)
  mask        -- legacy MaskConfig/DesignPoint + design(name) shims

The package re-exports the reference's names (`src/repro/core/__init__.py`).
"""
from repro_torch.core.design import (BypassSpec, Design, DramSpec,  # noqa: F401
                                     PartitionSpec, TokenSpec,
                                     TranslationSpec, get_design,
                                     list_designs, register_design)
from repro_torch.core.mask import (ALL_DESIGNS, DesignPoint,  # noqa: F401
                                   MaskConfig, design)
