from .kandinsky2_0 import Kandinsky2
from .kandinsky2_1 import Kandinsky2_1
from .kandinsky2_2 import Kandinsky2_2
