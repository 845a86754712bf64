select *
from (select i_manufact_id, sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price))
               over (partition by i_manufact_id) avg_quarterly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and d_month_seq in ({dms}, {dms} + 1, {dms} + 2, {dms} + 3,
                            {dms} + 4, {dms} + 5, {dms} + 6, {dms} + 7,
                            {dms} + 8, {dms} + 9, {dms} + 10, {dms} + 11)
        and ((i_category in ('Books', 'Children', 'Electronics')
              and i_class in ('booksclass1', 'childrenclass2',
                              'electronicsclass3', 'booksclass4')
              and i_brand in ('amalg #1', 'edu pack #2', 'exporti #3',
                              'amalg #4'))
          or (i_category in ('Women', 'Music', 'Men')
              and i_class in ('womenclass1', 'musicclass2', 'menclass3',
                              'womenclass4')
              and i_brand in ('brand #1', 'corp #2', 'maxi #3',
                              'brand #4')))
      group by i_manufact_id, d_qoy) tmp1
where case when avg_quarterly_sales > 0
           then abs(sum_sales - avg_quarterly_sales)
                / avg_quarterly_sales
           else null end > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id
limit 100
