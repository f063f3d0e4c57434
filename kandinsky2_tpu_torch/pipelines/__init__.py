from .kandinsky2_1 import Kandinsky2_1
