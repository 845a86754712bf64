select *
from (select avg(ss_list_price) b1_lp, count(ss_list_price) b1_cnt,
             count(distinct ss_list_price) b1_cntd
      from store_sales
      where ss_quantity between 0 and 5
        and (ss_list_price between {lp1} and {lp1} + 10
          or ss_coupon_amt between {ca1} and {ca1} + 1000
          or ss_wholesale_cost between {wc1} and {wc1} + 20)) b1,
     (select avg(ss_list_price) b2_lp, count(ss_list_price) b2_cnt,
             count(distinct ss_list_price) b2_cntd
      from store_sales
      where ss_quantity between 6 and 10
        and (ss_list_price between {lp2} and {lp2} + 10
          or ss_coupon_amt between {ca2} and {ca2} + 1000
          or ss_wholesale_cost between {wc2} and {wc2} + 20)) b2,
     (select avg(ss_list_price) b3_lp, count(ss_list_price) b3_cnt,
             count(distinct ss_list_price) b3_cntd
      from store_sales
      where ss_quantity between 11 and 15
        and (ss_list_price between {lp3} and {lp3} + 10
          or ss_coupon_amt between {ca3} and {ca3} + 1000
          or ss_wholesale_cost between {wc3} and {wc3} + 20)) b3,
     (select avg(ss_list_price) b4_lp, count(ss_list_price) b4_cnt,
             count(distinct ss_list_price) b4_cntd
      from store_sales
      where ss_quantity between 16 and 20
        and (ss_list_price between {lp4} and {lp4} + 10
          or ss_coupon_amt between {ca4} and {ca4} + 1000
          or ss_wholesale_cost between {wc4} and {wc4} + 20)) b4,
     (select avg(ss_list_price) b5_lp, count(ss_list_price) b5_cnt,
             count(distinct ss_list_price) b5_cntd
      from store_sales
      where ss_quantity between 21 and 25
        and (ss_list_price between {lp5} and {lp5} + 10
          or ss_coupon_amt between {ca5} and {ca5} + 1000
          or ss_wholesale_cost between {wc5} and {wc5} + 20)) b5,
     (select avg(ss_list_price) b6_lp, count(ss_list_price) b6_cnt,
             count(distinct ss_list_price) b6_cntd
      from store_sales
      where ss_quantity between 26 and 30
        and (ss_list_price between {lp6} and {lp6} + 10
          or ss_coupon_amt between {ca6} and {ca6} + 1000
          or ss_wholesale_cost between {wc6} and {wc6} + 20)) b6
limit 100
