"""Paper figure generators (host-side matplotlib over cached device data).

Each module rebuilds one of the reference's figure scripts on top of the
device MC engine and the shared cache schemas:

- fig1:  CDF-area example figures        (generate_example_fig1.py)
- fig3:  per-controller RIM heatmaps and best/median curves
         (generate_fig3.py — figs 3, 3e, 6, 10, 11, 12, 13)
- fig4:  Kendall-tau rank-consistency analysis
         (generate_fig4_kendallrankanalysis.py — figs 4, 7, 9)
- fig5:  ARIM curves (generate_arim_all_fig5.py)
- fig8:  ARIM vs function-call scaling (gen_fig_8_arim_fcall_scaling.py)
- rimk:  p-RIM theory exploration (exploring_rimk.py, rim_analysis.py)
"""

from code_robchar_tpu.figs.fig1 import CDFAreaExample
from code_robchar_tpu.figs.fig3 import IndividualContComparisons
from code_robchar_tpu.figs.fig4 import KTRConsistency
from code_robchar_tpu.figs.fig5 import ARIMGenerator
from code_robchar_tpu.figs.fig8 import NStochOpt
from code_robchar_tpu.figs.rimk import ExploringRIMK

__all__ = ["CDFAreaExample", "IndividualContComparisons", "KTRConsistency",
           "ARIMGenerator", "NStochOpt", "ExploringRIMK"]
