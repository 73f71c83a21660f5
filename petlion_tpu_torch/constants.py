"""Physical constants shared across the framework.

Reference parity: PETLION.jl defines `const_Faradays` and `const_Ideal_Gas`
(src/PETLION.jl). Values follow CODATA as used by the reference.
"""

FARADAY = 96485.3321233  # [C/mol]
IDEAL_GAS = 8.31446261815324  # [J/(mol K)]
T_REF = 298.15  # [K] reference temperature used by Arrhenius switches
