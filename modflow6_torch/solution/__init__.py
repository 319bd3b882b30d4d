from .ims import ImsSettings, NumericalSolution, SolveInfo
